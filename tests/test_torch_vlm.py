"""The port's internvl2-2b (``family="vlm"``) against the JAX package, on the CPU
at an f32 smoke size.

The config copy; the model-level image-prefix ``prefill`` (stub patch
embeddings before the tokens, ragged ``seq_lens`` shifted by the prefix, as
``test_decode_dispatch.py``'s case) and decode steps from its contiguous
cache, W8A8 on and off; and ``Engine.serve`` on the paged pool in BLOCKED,
HBCEM and LBIM, W8A8 on and off (served requests carry no image, as in the
JAX engine).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from serving_refs import BUDGETS, PROMPTS  # noqa: E402
from test_torch_serve import MODES, run_jax, run_torch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("internvl2-2b", smoke=True).replace(dtype="float32",
                                                           param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    yield jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp
    jax.clear_caches()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_copy_matches_jax(smoke):
    assert dataclasses.asdict(t_get_config("internvl2-2b", smoke=smoke)) == \
        dataclasses.asdict(get_config("internvl2-2b", smoke=smoke))
    full = t_get_config("internvl2-2b")
    assert (full.family, full.n_layers, full.q_per_kv, full.head_dim, full.d_ff,
            full.n_prefix_tokens) == ("vlm", 24, 2, 128, 8192, 256)


def test_params_tree_is_the_dense_tree(models):
    jcfg, tcfg, jp, tp = models
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(tp) == set(jp)
    assert set(fresh["layers"][0]) == set(tp["layers"][0]) == {"attn_norm", "attn",
                                                               "mlp_norm", "mlp"}
    np.testing.assert_array_equal(tp["layers"][1]["mlp"]["w_up"].numpy(),
                                  np.asarray(jp["layers"]["mlp"]["w_up"][1]))


def _prefix_batch(jcfg, b=2, s=8, seed=1):
    r = np.random.default_rng(seed)
    toks = r.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    pre = (0.02 * r.standard_normal((b, jcfg.n_prefix_tokens, jcfg.d_model))).astype(np.float32)
    return toks, pre


@pytest.mark.parametrize("quantized", [False, True])
def test_prefix_prefill_then_decode_vs_jax(models, quantized):
    """Ragged rows behind the image prefix: logits at P + seq_lens - 1, the
    cache filled over prefix + tokens, ``pos`` P + S; then decode steps from
    that contiguous cache (B4 path; the W8A8 GEMVs when quantized), each
    step starting both sides from the JAX cache."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (c.replace(quantized_decode=quantized) for c in (jcfg, tcfg))
    toks, pre = _prefix_batch(jcfg)
    lens = [5, 8]
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pre)},
                        jcfg, max_len=32, seq_lens=jnp.asarray(lens, jnp.int32))
    tl, tc = TM.prefill(tp, t(toks).long(), tcfg, max_len=32, seq_lens=torch.tensor(lens),
                        prefix_embeds=t(pre))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == jcfg.n_prefix_tokens + toks.shape[1]
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    # the gathered rows are the prefix-shifted ones: a prefix-free prefill of
    # the same tokens reads other hidden states
    nl, _ = TM.prefill(tp, t(toks).long(), tcfg, max_len=32, seq_lens=torch.tensor(lens))
    assert not torch.allclose(nl, tl)
    r = np.random.default_rng(4)
    jc = dict(jc, pos=jnp.asarray([jcfg.n_prefix_tokens + n for n in lens], jnp.int32))
    for _ in range(3):
        tokens = r.integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        tc = {k: t(v) for k, v in jc.items()}
        k_before = tc["k"]
        jlog, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
        tlog, tc = TM.decode_step(tp, tc, t(tokens).long(), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
        assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
        assert tc["k"] is k_before                          # written in place
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-4, atol=1e-5)


def test_prefix_embeds_is_the_vlm_family_input(models):
    _, tcfg, _, tp = models
    toks, pre = _prefix_batch(tcfg)
    with pytest.raises(ValueError, match="vlm"):
        TM.prefill(tp, t(toks).long(), tcfg.replace(family="dense"), 32,
                   prefix_embeds=t(pre))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_engine_serve_matches_jax(models, mode, quantized):
    """The paged pool (the dense path: prefix reuse and staged admission),
    W8A8 on and off: tokens, states, events and the report equal the JAX
    engine's."""
    jcfg, tcfg, jp, tp = models
    sm = ServingModel.prepare(tcfg, tp, max_len=64, slots=2, device="cpu")
    assert sm.cache_pool().paged
    jres, jev, jrep = run_jax(jcfg, jp, mode, PROMPTS, BUDGETS, quantized=quantized)
    tres, tev, trep = run_torch(tcfg, tp, mode, PROMPTS, BUDGETS, quantized=quantized)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert all(r[2] == "finished" for r in tres)
