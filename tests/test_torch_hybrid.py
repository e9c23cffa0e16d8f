"""The port's zamba2 hybrid against the JAX package, on the CPU at an f32
smoke size.

The config copy, the hybrid weight tree through ``params_from_numpy``, the
decode cache and ``decode_step`` here; ``Engine.serve`` in BLOCKED, HBCEM and
LBIM (tokens, request states and ``ScheduleEvent`` streams equal to the JAX
engine's) in ``test_torch_hybrid_serve.py``, and everything with W8A8 decode
in ``test_torch_hybrid_w8a8.py``: split to keep each file short. The hybrid's pool keeps
contiguous lanes; its recurrent Mamba2 state is zeroed on retire, so a lane
reused by another request starts clean.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.pim_modes import Mode as JMode  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.api import GenerationRequest  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from serving_refs import MAX_LEN  # noqa: E402
from test_torch_serve import REPORT_KEYS, event_fields, result_fields  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("zamba2-7b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    # jit: the eager init of the hybrid tree takes seconds of dispatch
    jp = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def test_config_copy_matches_jax():
    for smoke in (False, True):
        assert dataclasses.asdict(t_get_config("zamba2-7b", smoke=smoke)) == \
            dataclasses.asdict(get_config("zamba2-7b", smoke=smoke))
    full = t_get_config("zamba2-7b")
    assert (full.n_layers, full.d_model, full.head_dim, full.q_per_kv) == (81, 3584, 112, 1)
    assert TM._hybrid_groups(full) == 13


def test_params_from_numpy_hybrid_tree(models):
    """Both layer-stacked subtrees split per layer, bit for bit; the shared
    block stays one dict."""
    jcfg, _, jp, tp = models
    assert len(tp["mamba_layers"]) == jcfg.n_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        arr = np.asarray(leaf)
        if keys[0] == "mamba_layers":
            for i in range(jcfg.n_layers):
                node = tp["mamba_layers"][i]
                for k in keys[1:]:
                    node = node[k]
                np.testing.assert_array_equal(node.numpy(), arr[i])
        else:
            node = tp
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), arr)


def test_init_params_and_prepare_match_jax_structure(models):
    jcfg, tcfg, jp, tp = models
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(tp)
    assert set(fresh["mamba_layers"][0]["ssm"]) == set(tp["mamba_layers"][0]["ssm"])
    for key in ("attn", "mlp"):
        for name, leaf in tp["shared_attn"][key].items():
            assert fresh["shared_attn"][key][name].shape == leaf.shape
    jprep = jquant.prepare_decode_params(jp)
    tprep = tquant.prepare_decode_params(tp)
    for sub, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_up")):
        tl, jl = tprep["shared_attn"][sub][name], jprep["shared_attn"][sub][name]
        assert isinstance(tl, tquant.PreparedLinear)
        np.testing.assert_array_equal(tl.w_q.numpy(), np.asarray(jl.w_q))
    # Mamba2 projections are plain matmuls: left as they are
    assert tprep["mamba_layers"][0]["ssm"]["w_x"] is tp["mamba_layers"][0]["ssm"]["w_x"]


def test_decode_cache_matches_jax(models):
    jcfg, tcfg, _, _ = models
    jc = JM.init_decode_cache(jcfg, 3, 16)
    specs = TM.decode_cache_specs(tcfg, 3, 16)
    assert set(specs) == set(jc)
    for key, (shape, _) in specs.items():
        assert shape == jc[key].shape, key
    assert specs["ssd"][1] == torch.float32


def test_hybrid_decode_step_vs_jax(models):
    """W8A8 decode off here; on in ``test_torch_hybrid_w8a8.py``."""
    check_decode_steps(models, quantized=False)


def check_decode_steps(models, quantized):
    """A ragged batch through steps of 4, 1, 1 and 4 tokens from random
    states: logits, greedy tokens and every cache leaf against JAX, the
    stacked leaves written in place. Each step starts both sides from the
    JAX cache of the step before: under W8A8 an f32 difference of an ulp can
    flip one activation's int8 rounding, and carried over steps that would
    compare two different roundings, not the two step functions."""
    jcfg, tcfg, jp, tp = models
    jcfg = jcfg.replace(quantized_decode=quantized)
    tcfg = tcfg.replace(quantized_decode=quantized)
    b, lmax = 3, 24
    r = np.random.default_rng(7)
    jc = JM.init_decode_cache(jcfg, b, lmax)
    jc = {k: jnp.asarray((r.standard_normal(v.shape) * 0.1).astype(np.float32))
          for k, v in jc.items() if k != "pos"}
    jc["pos"] = jnp.asarray([0, 5, 9], jnp.int32)
    for tok in (4, 1, 1, 4):
        tokens = r.integers(1, jcfg.vocab_size, (b, tok)).astype(np.int32)
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        leaves = {k: v for k, v in tc.items() if k != "pos"}
        pos = np.asarray(jc["pos"])
        jlog, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
        tlog, tc = TM.decode_step(tp, tc, torch.from_numpy(tokens).long(), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
        assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
        assert tc["pos"].tolist() == (pos + tok).tolist()
        for k, leaf in leaves.items():
            assert tc[k] is leaf                      # in place, never copied
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jc[k]), rtol=1e-4,
                                       atol=1e-5)


# --------------------------------------------------------------------------
# Engine.serve
# --------------------------------------------------------------------------


def run_jax(jcfg, jp, mode, prompts, budgets, quantized):
    cfg = jcfg.replace(quantized_decode=quantized)
    eng = JServing.prepare(cfg, jp, max_len=MAX_LEN, slots=2).engine(mode=JMode[mode],
                                                                      chunk=4)
    assert not eng.pool.paged
    res = eng.serve([JReq(prompt=p, max_new_tokens=b) for p, b in zip(prompts, budgets)])
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def run_torch(tcfg, tp, mode, prompts, budgets, quantized):
    cfg = tcfg.replace(quantized_decode=quantized)
    eng = ServingModel.prepare(cfg, tp, max_len=MAX_LEN, slots=2, device="cpu").engine(
        mode=Mode[mode], chunk=4)
    assert not eng.pool.paged and not eng.pool.prefix_cache
    res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                     for p, b in zip(prompts, budgets)])
    assert eng.pool.check_invariants() == []
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def test_hybrid_pool_round_trip_zeroes_recurrent_state(models):
    """insert -> retire -> insert: KV stays behind pos = 0 as dead weight, the
    recurrent leaves are zeroed at retire, and a lane reused by a second
    request carries that request's state alone."""
    jcfg, tcfg, _, _ = models
    jspecs = jcache.derive_state_specs(jcfg)
    tspecs = tcache.derive_state_specs(tcfg)
    assert [(s.kind, s.keys, s.zero_on_retire) for s in tspecs] == \
        [(s.kind, s.keys, s.zero_on_retire) for s in jspecs]
    tpol, jpol = tcache.derive_policy(tspecs), jcache.derive_policy(jspecs)
    assert (tpol.ragged_batch_ok, tpol.prefix_capable) == \
        (jpol.ragged_batch_ok, jpol.prefix_capable)
    pool = tcache.CachePool(tcfg, 16, 2, paged=True, device="cpu")   # asks; cannot page
    assert not pool.paged and not pool.prefix_cache
    req = GenerationRequest(prompt=[1, 2, 3], max_new_tokens=2)
    first, _ = pool.stage_admission(req.prompt)
    for k in ("ssd", "conv_x", "conv_bc", "k", "v"):
        first[k].fill_(1.0)
    first["pos"] = torch.tensor([3], dtype=torch.int32)
    si = pool.alloc(req, 0)
    pool.insert(si, first)
    view = pool.views()
    assert all(bool((view[k][:, si] == 1).all()) for k in ("ssd", "conv_x", "conv_bc", "k"))
    pool.retire(si)
    view = pool.views()
    for k in ("ssd", "conv_x", "conv_bc"):
        assert not view[k][:, si].any(), k            # zeroed on retire
    assert bool((view["k"][:, si] == 1).all())        # KV: masked by pos, not zeroed
    assert view["pos"].tolist()[si] == 0 and pool.check_invariants() == []
    second, _ = pool.stage_admission([4, 5])
    second["ssd"].fill_(2.0)
    second["pos"] = torch.tensor([2], dtype=torch.int32)
    si2 = pool.alloc(GenerationRequest(prompt=[4, 5], max_new_tokens=1), 1)
    assert si2 == si
    pool.insert(si2, second)
    view = pool.views()
    assert bool((view["ssd"][:, si2] == 2).all()) and not view["conv_x"][:, si2].any()
    assert not view["ssd"][:, 1 - si2].any()          # the other lane never touched
