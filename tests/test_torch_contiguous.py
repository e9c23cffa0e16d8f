"""The port's contiguous pool against the JAX package, on the CPU.

Kernel B4 (contiguous flash decode): the wrapper's CPU path, its plain
version, against the JAX reference and the Pallas kernel in interpret mode,
at llama3-8b's grouping (G 4) and zamba2's (G 1, hd 112), with an empty
range, a ``start`` and a softcap. Then the contiguous half of the KV mapping
(bit-exact), the contiguous decode step, and ``Engine.serve`` over a
``cache_pool(paged=False)`` for llama3-8b smoke at f32: tokens, request
states and ``ScheduleEvent`` streams equal to the JAX engine's, and inside the
port equal to the paged pool's tokens.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import kv_mapping as jkv  # noqa: E402
from repro.core.pim_modes import Mode as JMode  # noqa: E402
from repro.kernels.decode_attention import ref as jref  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention_op as j_op  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import kv_mapping as tkv  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as da  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.api import GenerationRequest  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402
from test_torch_serve import REPORT_KEYS, event_fields, result_fields  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


# --------------------------------------------------------------------------
# kernel B4: plain version and wrapper against the JAX reference and Pallas
# --------------------------------------------------------------------------

# f32 on both sides; XLA and torch contract q.K and p.V in different orders
TOL = dict(rtol=2e-5, atol=2e-5)

# (G, hd, Lmax, softcap): llama3-8b's grouping, zamba2's G 1 with hd 112
# (not a multiple of 32), and a softcap
B4_CASES = [(4, 32, 40, None), (1, 112, 24, None), (2, 16, 33, 5.0)]


def contiguous_setup(g, hd, lmax, seed=3, b=4, hkv=2):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hkv * g, hd)).astype(np.float32)
    k = (r.standard_normal((b, hkv, hd, lmax)) * 0.3).astype(np.float32)
    v = (r.standard_normal((b, hkv, lmax, hd)) * 0.3).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g,hd,lmax,cap", B4_CASES)
def test_contiguous_attention_vs_jax(g, hd, lmax, cap):
    """Full, ragged, empty and windowed (start > 0) lanes in one batch."""
    q, k, v = contiguous_setup(g, hd, lmax)
    end = np.asarray([lmax, 9, 0, lmax - 2], np.int32)
    start = np.asarray([0, 0, 0, 7], np.int32)
    before = launch_counts()
    out = decode_attention_op(t(q), t(k), t(v), t(end), start=t(start), scale=hd ** -0.5,
                              softcap=cap).numpy()
    assert launch_counts() == before             # CPU: the plain version, no launch
    kw = dict(start=jnp.asarray(start), scale=hd ** -0.5, softcap=cap)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(end))
    np.testing.assert_allclose(out, np.asarray(j_op(*args, use_kernel=False, **kw)), **TOL)
    pallas = np.asarray(j_op(*args, block_l=8, interpret=True, **kw))
    np.testing.assert_allclose(out, pallas, **TOL)
    assert not out[2].any()                       # empty range -> exact zeros


@pytest.mark.parametrize("g,hd,lmax,cap", B4_CASES)
def test_contiguous_plain_version_vs_jax_ref(g, hd, lmax, cap):
    q, k, v = contiguous_setup(g, hd, lmax, seed=5)
    b, hq, _ = q.shape
    qg = q.reshape(b, 2, g, hd)
    end = np.asarray([lmax, 1, 0, 20], np.int32)
    start = np.asarray([3, 0, 0, 20], np.int32)   # lane 3: start == end, empty
    out = tref.decode_attention_ref(t(qg), t(k), t(v), t(end), 0.3, cap,
                                    start=t(start)).numpy()
    want = np.asarray(jref.decode_attention_ref(jnp.asarray(qg), jnp.asarray(k),
                                                jnp.asarray(v), jnp.asarray(end), 0.3, cap,
                                                start=jnp.asarray(start)))
    np.testing.assert_allclose(out, want, **TOL)
    assert not out[2].any() and not out[3].any()
    # the wrapper's CPU path is the plain version itself, bit for bit
    wrapped = da.decode_attention(t(qg), t(k), t(v), t(end), t(start), scale=0.3,
                                  softcap=cap)
    assert torch.equal(wrapped, torch.from_numpy(out))


def test_contiguous_wrapper_refuses_meta_tensors():
    before = launch_counts()
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        da.decode_attention(torch.empty((1, 2, 1, 16), **meta),
                            torch.empty((1, 2, 16, 8), **meta),
                            torch.empty((1, 2, 8, 16), **meta), 4, scale=0.25)
    assert launch_counts() == before


# --------------------------------------------------------------------------
# contiguous KV mapping: bit-exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tok,pos", [(1, [0, 7, 11]), (4, [0, 3, 8]), (3, 5),
                                     (4, [2, 12, 9])])
def test_append_layer_bit_exact(tok, pos):
    """Column writes into K, row writes into V, in place; a window that would
    run past Lmax is moved back to end at Lmax, as dynamic_update_slice does
    (the last case: lane 1 at 12 with 4 tokens in 14 columns)."""
    r = np.random.default_rng(tok)
    b, h, hd, lmax = 3, 2, 8, 14
    k = r.standard_normal((b, h, hd, lmax)).astype(np.float32)
    v = r.standard_normal((b, h, lmax, hd)).astype(np.float32)
    k_new = r.standard_normal((b, h, tok, hd)).astype(np.float32)
    v_new = r.standard_normal((b, h, tok, hd)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    jk, jv = jkv.append_layer(jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_new),
                              jnp.asarray(v_new), jnp.asarray(p))
    tk, tv = t(k), t(v)
    tkv.append_layer(tk, tv, t(k_new), t(v_new), t(p))      # in place
    np.testing.assert_array_equal(bits(tk.numpy()), bits(jk))
    np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))


def test_init_cache_matches_jax():
    jc = jkv.init_cache(3, 2, 4, 16, 20, jnp.float32)
    tc = tkv.init_cache(3, 2, 4, 16, 20, torch.float32, "cpu")
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape and not tc[key].any()
    assert int(tc["pos"]) == int(jc["pos"]) == 0


# --------------------------------------------------------------------------
# the contiguous decode step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


@pytest.mark.parametrize("tok", [1, 4])
@pytest.mark.parametrize("quantized", [False, True])
def test_contiguous_decode_step_vs_jax(models, tok, quantized):
    jcfg, tcfg, jp, tp = models
    jcfg = jcfg.replace(quantized_decode=quantized)
    tcfg = tcfg.replace(quantized_decode=quantized)
    b, lmax = 3, 24
    r = np.random.default_rng(tok)
    k = (r.standard_normal((jcfg.n_layers, b, jcfg.n_kv_heads, jcfg.head_dim, lmax))
         * 0.5).astype(np.float32)
    v = (r.standard_normal((jcfg.n_layers, b, jcfg.n_kv_heads, lmax, jcfg.head_dim))
         * 0.5).astype(np.float32)
    pos = np.asarray([0, 9, 17], np.int32)
    tokens = r.integers(1, jcfg.vocab_size, (b, tok)).astype(np.int32)
    jlog, jc = JM.decode_step(jp, {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                   "pos": jnp.asarray(pos)}, jnp.asarray(tokens), jcfg)
    tc = {"k": t(k), "v": t(v), "pos": t(pos)}
    k_before = tc["k"]
    tlog, tc2 = TM.decode_step(tp, tc, t(tokens).long(), tcfg)
    assert tc2["k"] is k_before                      # written in place, not copied
    assert tc2["pos"].tolist() == (pos + tok).tolist()
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
    for key in ("k", "v"):
        np.testing.assert_allclose(tc2[key].numpy(), np.asarray(jc[key]), rtol=1e-5,
                                   atol=1e-5)


def test_decode_cache_matches_jax(models):
    jcfg, tcfg, _, _ = models
    jc = JM.init_decode_cache(jcfg, 3, 16)
    specs = TM.decode_cache_specs(tcfg, 3, 16)
    assert set(specs) == {k for k in jc if k != "layout"}
    for key, (shape, dtype) in specs.items():
        assert shape == jc[key].shape, key
    assert specs["k"][1] == torch.float32


# --------------------------------------------------------------------------
# Engine.serve over the contiguous pool
# --------------------------------------------------------------------------


def run_jax(jcfg, jp, mode, quantized):
    cfg = jcfg.replace(quantized_decode=quantized)
    sm = JServing.prepare(cfg, jp, max_len=MAX_LEN, slots=2)
    eng = JEngine(sm.cfg, jp, max_len=MAX_LEN, slots=2, mode=JMode[mode], chunk=4,
                  serving=sm, prefix_cache=False,
                  pool=sm.cache_pool(slots=2, prefix_cache=False, block_size=4, paged=False))
    assert not eng.pool.paged
    res = eng.serve([JReq(prompt=p, max_new_tokens=b) for p, b in zip(PROMPTS, BUDGETS)])
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def torch_engine(tcfg, tp, mode, quantized, paged, prefix=False):
    cfg = tcfg.replace(quantized_decode=quantized)
    sm = ServingModel.prepare(cfg, tp, max_len=MAX_LEN, slots=2, device="cpu")
    return Engine(cfg, tp, max_len=MAX_LEN, slots=2, mode=Mode[mode], chunk=4, serving=sm,
                  prefix_cache=prefix,
                  pool=sm.cache_pool(slots=2, prefix_cache=prefix, block_size=4, paged=paged))


def run_torch(tcfg, tp, mode, quantized, paged=False, prefix=False):
    eng = torch_engine(tcfg, tp, mode, quantized, paged, prefix)
    assert eng.pool.paged == paged
    res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                     for p, b in zip(PROMPTS, BUDGETS)])
    assert eng.pool.check_invariants() == []
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_contiguous_serve_matches_jax(models, mode, quantized):
    jcfg, tcfg, jp, tp = models
    jres, jev, jrep = run_jax(jcfg, jp, mode, quantized)
    tres, tev, trep = run_torch(tcfg, tp, mode, quantized)
    assert tres == jres
    assert tev == jev
    assert trep == jrep
    assert all(r[2] == "finished" for r in tres)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prefix", [True, False])
def test_contiguous_pool_tokens_equal_paged_pool(models, mode, prefix):
    """As the JAX package pins (test_cache_pool): the paged pool changes
    residency, not one token, prefix reuse on or off."""
    _, tcfg, _, tp = models
    paged = run_torch(tcfg, tp, mode, False, paged=True, prefix=prefix)[0]
    contiguous = run_torch(tcfg, tp, mode, False, paged=False)[0]
    assert [r[0] for r in paged] == [r[0] for r in contiguous]


def test_contiguous_pool_protocol_and_policy(models):
    """The state specs and admission policy equal the JAX package's; a
    contiguous pool holds no pages, reuses no prefix, zeroes fill on retire
    and writes lanes in place."""
    jcfg, tcfg, _, _ = models
    jspecs = jcache.derive_state_specs(jcfg)
    tspecs = tcache.derive_state_specs(tcfg)
    assert [(s.kind, s.keys, s.zero_on_retire) for s in tspecs] == \
        [(s.kind, s.keys, s.zero_on_retire) for s in jspecs]
    tpol, jpol = tcache.derive_policy(tspecs), jcache.derive_policy(jspecs)
    assert (tpol.ragged_batch_ok, tpol.prefix_capable) == \
        (jpol.ragged_batch_ok, jpol.prefix_capable)
    pool = tcache.CachePool(tcfg, 16, 2, paged=False, device="cpu")
    assert not pool.paged and not pool.prefix_cache and pool.peek_prefix([1] * 12) == 0
    k_leaf = pool.views()["k"]
    staging, skip = pool.stage_admission([1, 2, 3])
    assert skip == 0 and tuple(staging["pos"].shape) == (1,)
    staging["k"].fill_(1.0)
    staging["pos"] = torch.tensor([3], dtype=torch.int32)
    si = pool.alloc(GenerationRequest(prompt=[1, 2, 3], max_new_tokens=2), 0)
    pool.insert(si, staging)
    view = pool.views()
    assert view["k"] is k_leaf and bool((view["k"][:, si] == 1).all())
    assert view["pos"].tolist()[si] == 3
    pool.retire(si)
    assert pool.views()["pos"].tolist() == [0, 0] and pool.check_invariants() == []
    occ = pool.occupancy()
    assert occ.pages_total == 0 and occ.slots_used == 0
    assert pool.prefix_report()["stored_blocks"] == 0
