"""The MoE family in the port against the JAX package, on the CPU at f32 smoke
sizes and at the smoke configs' own capacity factor (2.0): olmoe-1b-7b (E 8,
top-2; a 4-token call has capacity 2, an 8-token call 4, so picks drop) and
phi3.5-moe (E 4, top-2; capacity equals the token count at 4 and 8 tokens,
the no-drop case).

The router (weights, indices and their order, ties included), the capacity
dispatch and the all-experts form are held against ``repro.models.moe``;
``decode_step`` (paged, with two free lanes colliding on the dummy page, and
contiguous; W8A8 on and off) and a ragged padded ``prefill`` against
``M.decode_step`` / ``M.prefill``; the expert tables stay float under W8A8.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoe  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.core.quant import PreparedLinear, prepare_decode_params  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoe  # noqa: E402
from test_torch_gemma2 import _contiguous_cache  # noqa: E402
from test_torch_model import paged_cache, t  # noqa: E402

ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
TOL = dict(rtol=1e-5, atol=1e-5)          # model outputs
MOE_TOL = dict(rtol=1e-5, atol=1e-6)      # the MoE FFN alone


def _cfgs(arch):
    jcfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_jax(arch, smoke):
    assert arch in list_archs()
    tcfg = t_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(get_config(arch, smoke=smoke))
    assert tcfg.token_coupled


def test_full_width_shapes():
    ol, phi = t_get_config("olmoe-1b-7b"), t_get_config("phi3.5-moe-42b-a6.6b")
    assert (ol.n_layers, ol.d_model, ol.q_per_kv, ol.head_dim, ol.n_experts, ol.top_k,
            ol.d_ff, ol.vocab_size) == (16, 2048, 1, 128, 64, 8, 1024, 50304)
    assert (phi.n_layers, phi.d_model, phi.q_per_kv, phi.head_dim, phi.n_experts, phi.top_k,
            phi.d_ff, phi.vocab_size) == (32, 4096, 4, 128, 16, 2, 6400, 32064)
    assert not t_get_config("llama3-8b").token_coupled


def test_params_tree_splits_expert_tables(models):
    """The stacked ``(nL, E, d, f)`` expert tables become per-layer ``(E, d,
    f)`` slices; the port's own init draws the same tree and shapes."""
    jcfg, tcfg, jp, tp = models
    for i, lp in enumerate(tp["layers"]):
        assert "mlp" not in lp and set(lp["moe"]) == {"router", "w_gate", "w_up", "w_down"}
        for k, leaf in lp["moe"].items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jp["layers"]["moe"][k][i]))
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(tp["layers"][0]["moe"]["w_down"].shape) == (e, f, d)
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh["layers"][1]["moe"].items()} == \
        {k: tuple(v.shape) for k, v in tp["layers"][1]["moe"].items()}


def test_prepared_linear_gate_skips_the_experts(models):
    """W8A8 preparation quantizes the 2-D attention projections only: the
    stacked expert tables (3-D) and the router stay float, shared."""
    _, _, _, tp = models
    dp = prepare_decode_params(tp)
    for lp, raw in zip(dp["layers"], tp["layers"]):
        assert all(isinstance(lp["attn"][k], PreparedLinear) for k in ("wq", "wk", "wv", "wo"))
        assert not any(isinstance(v, PreparedLinear) for v in lp["moe"].values())
        assert all(lp["moe"][k] is raw["moe"][k] for k in raw["moe"])


# --------------------------------------------------------------------------
# router
# --------------------------------------------------------------------------


def _router_pair(arch, router, x, dtype):
    jcfg, tcfg = _cfgs(arch)
    jw, jidx, jprobs = JMoe._router({"router": jnp.asarray(router, dtype)},
                                    jnp.asarray(x, dtype), jcfg)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    tw, tidx, tprobs = TMoe._router({"router": torch.from_numpy(router).to(tdt)},
                                    torch.from_numpy(x).to(tdt), tcfg)
    return (np.asarray(jw.astype(jnp.float32)), np.asarray(jidx), np.asarray(jprobs),
            tw.float().numpy(), tidx.numpy(), tprobs.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    r = np.random.default_rng(1)
    x = r.standard_normal((16, 64)).astype(np.float32)
    router = (r.standard_normal((64, _cfgs(arch)[0].n_experts)) / 8).astype(np.float32)
    jw, jidx, jprobs, tw, tidx, tprobs = _router_pair(arch, router, x, jnp.float32)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(tw, jw, **MOE_TOL)
    np.testing.assert_allclose(tprobs, jprobs, **MOE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_break_to_the_lower_index(arch):
    """A zero router ties every expert: the picks are experts 0..k-1 in that
    order with weight 1/k, as ``jax.lax.top_k`` gives them."""
    jcfg, _ = _cfgs(arch)
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    jw, jidx, _, tw, tidx, _ = _router_pair(arch, np.zeros((64, jcfg.n_experts), np.float32),
                                            x, jnp.float32)
    np.testing.assert_array_equal(tidx, jidx)
    assert (tidx == np.arange(jcfg.top_k)).all()
    np.testing.assert_array_equal(tw, jw)


def test_router_bf16_ties_match_jax():
    """bf16 logits that tie exactly: small integers times a router whose
    experts come in equal pairs (and, on some rows, three equal leaders across
    the top-2 cut). Indices, their order and the weights equal JAX's."""
    r = np.random.default_rng(3)
    x = r.integers(-2, 3, (12, 64)).astype(np.float32)
    half = r.integers(-1, 2, (64, 4)).astype(np.float32)
    router = np.repeat(half, 2, axis=1)        # experts (2j, 2j+1) tie on every row
    router[:, 2] = router[:, 0]                # and expert 2 with experts 0 and 1
    jw, jidx, _, tw, tidx, _ = _router_pair("olmoe-1b-7b", router, x, jnp.bfloat16)
    logits = x @ router
    assert any(len(set(row)) < len(row) for row in logits)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tw, jw)


# --------------------------------------------------------------------------
# capacity dispatch
# --------------------------------------------------------------------------


def _moe_pair(arch, t_tokens, seed, concentrated):
    """JAX and port MoE params and (t, d) inputs; ``concentrated`` inputs are
    one shared row plus a little noise, so their picks pile onto the same
    experts."""
    jcfg, tcfg = _cfgs(arch)
    jp = JMoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: t(v) for k, v in jp.items()}
    r = np.random.default_rng(seed)
    if concentrated:
        x = r.standard_normal((1, 64)) + 0.05 * r.standard_normal((t_tokens, 64))
    else:
        x = r.standard_normal((t_tokens, 64))
    return jcfg, tcfg, jp, tp, x.astype(np.float32)


def _drops(tp, x, tcfg) -> int:
    n_groups, sg, cap = TMoe.capacity(x.shape[0], tcfg)
    _, idx, _ = TMoe._router(tp, torch.from_numpy(x), tcfg)
    _, keep = TMoe.keep_rule(idx.reshape(n_groups, sg, tcfg.top_k), tcfg.n_experts, cap)
    return int((~keep).sum())


@pytest.mark.parametrize("arch,t_tokens,concentrated,groups,cap", [
    ("olmoe-1b-7b", 4, True, 1, 2),        # a 4-lane decode step: picks drop
    ("olmoe-1b-7b", 8, True, 1, 4),        # an 8-token chunk: picks drop
    ("olmoe-1b-7b", 130, False, 2, 32),    # two groups of 65 (t > moe_group_size)
    ("olmoe-1b-7b", 129, False, 1, 64),    # t % n_groups != 0: one group of 129
    ("phi3.5-moe-42b-a6.6b", 4, True, 1, 4),    # cap == t: nothing can drop
    ("phi3.5-moe-42b-a6.6b", 8, True, 1, 8),
])
def test_moe_einsum_and_dense_match_jax(arch, t_tokens, concentrated, groups, cap):
    jcfg, tcfg, jp, tp, x = _moe_pair(arch, t_tokens, t_tokens, concentrated)
    assert TMoe.capacity(t_tokens, tcfg)[::2] == (groups, cap)
    je = np.asarray(JMoe.moe_einsum(jp, jnp.asarray(x), jcfg))
    jd = np.asarray(JMoe.moe_dense(jp, jnp.asarray(x), jcfg))
    te = TMoe.moe_einsum(tp, torch.from_numpy(x), tcfg).numpy()
    td = TMoe.moe_dense(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(te, je, **MOE_TOL)
    np.testing.assert_allclose(td, jd, **MOE_TOL)
    drops = _drops(tp, x, tcfg)
    if arch == "olmoe-1b-7b" and concentrated:
        assert drops > 0 and not np.allclose(je, jd, **MOE_TOL)   # JAX dropped them too
    if cap == t_tokens:
        assert drops == 0
        np.testing.assert_allclose(te, td, **MOE_TOL)


def test_moe_keeps_batch_shape(models):
    _, tcfg, _, tp = models
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 4, 64)).astype(
        np.float32))
    y = TMoe.moe_einsum(tp["layers"][0]["moe"], x, tcfg)
    assert y.shape == x.shape and torch.equal(
        y, TMoe.moe_einsum(tp["layers"][0]["moe"], x.reshape(12, 64), tcfg).reshape(3, 4, 64))


# --------------------------------------------------------------------------
# decode step and prefill
# --------------------------------------------------------------------------


def _steps(jcfg, tcfg, jp, tp, c, tokens_per_step):
    """Steps from one cache on both sides; each step starts from the JAX
    cache of the step before. Logits, greedy tokens and every written leaf
    (in place) within tolerance, pages bit-equal where only moved."""
    for tokens in tokens_per_step:
        tc = {k: t(v) for k, v in c.items()}
        leaves = {k: v for k, v in tc.items() if k not in ("pos", "block_table")}
        jlog, jc2 = JM.decode_step(jp, {k: jnp.asarray(v) for k, v in c.items()},
                                   jnp.asarray(tokens), jcfg)
        tlog, tc2 = TM.decode_step(tp, tc, t(tokens).long(), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
        for k, leaf in leaves.items():
            assert tc2[k] is leaf
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jc2[k]), **TOL)
        c = {k: np.asarray(v) for k, v in jc2.items()}


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_steps_vs_jax(models, quantized):
    """Four lanes: two live (fills 9, 17) and two free at fill 0 whose table
    rows are the dummy page, fed different tokens (a lane that just retired
    feeds its last token): their writes collide in the dummy page, the last
    lane's win on both sides, and their MoE picks compete with the live
    lanes' for capacity. Three one-token steps, then one 3-token step of the
    live lanes."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (cf.replace(quantized_decode=quantized) for cf in (jcfg, tcfg))
    c = paged_cache(jcfg, b=4, nb=6, bsz=4, pos=[0, 9, 17, 0], seed=1)
    c["block_table"][[0, 3]] = 0
    r = np.random.default_rng(7)
    _steps(jcfg, tcfg, jp, tp, c,
           [np.asarray([[3], [r.integers(1, 256)], [r.integers(1, 256)], [0]], np.int32)
            for _ in range(3)])
    c = paged_cache(jcfg, b=2, nb=6, bsz=4, pos=[5, 11], seed=2)
    _steps(jcfg, tcfg, jp, tp, c, [r.integers(1, 256, (2, 3)).astype(np.int32)])


@pytest.mark.parametrize("quantized", [False, True])
def test_contiguous_decode_steps_vs_jax(models, quantized):
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (cf.replace(quantized_decode=quantized) for cf in (jcfg, tcfg))
    c = _contiguous_cache(jcfg, 4, 24, [0, 9, 17, 0], seed=3)
    r = np.random.default_rng(8)
    _steps(jcfg, tcfg, jp, tp, c,
           [r.integers(0, 256, (4, 1)).astype(np.int32) for _ in range(3)]
           + [r.integers(0, 256, (4, 4)).astype(np.int32)])


def test_last_wins_scatter_on_colliding_lanes():
    """Colliding one-token writes (free lanes on the dummy page) leave the
    last colliding lane's K/V, the bits the JAX scatter gives on the CPU."""
    from repro.core import kv_mapping as jkv
    from repro_torch.core import kv_mapping as tkv

    r = np.random.default_rng(4)
    kp = r.standard_normal((5, 2, 8, 4)).astype(np.float32)
    vp = r.standard_normal((5, 2, 4, 8)).astype(np.float32)
    k_new = r.standard_normal((4, 2, 1, 8)).astype(np.float32)
    v_new = r.standard_normal((4, 2, 1, 8)).astype(np.float32)
    table = np.asarray([[0, 0], [3, 4], [0, 0], [1, 2]], np.int32)
    pos = np.asarray([0, 6, 0, 2], np.int32)
    jk, jv = jkv.append_layer_paged(*(jnp.asarray(a) for a in (kp, vp, k_new, v_new, pos,
                                                                table)), 4)
    tk, tv = t(kp), t(vp)
    tkv.append_layer_paged(tk, tv, t(k_new), t(v_new), t(pos), t(table), 4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[0, :, :, 0], k_new[2, :, 0, :])


def test_ragged_padded_prefill_vs_jax(monkeypatch):
    """A right-padded batch (lengths 11, 4, 9; pads are token 0) through one
    pass: each layer's MoE sees all 33 tokens, pads included, in row-major
    order. Logits at each row's last token and the KV equal JAX's. The pads
    take capacity: their kept picks fill expert slots ahead of row 2's tokens,
    and real picks drop behind them."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    lens = np.asarray([11, 4, 9], np.int32)
    toks = np.zeros((3, 11), np.int32)
    r = np.random.default_rng(4)
    for i, n in enumerate(lens):
        toks[i, :n] = r.integers(1, 256, n)
    seen = []
    keep_rule = TMoe.keep_rule

    def record(idx, n_experts, cap):
        slot, keep = keep_rule(idx, n_experts, cap)
        seen.append((idx.reshape(-1, tcfg.top_k), keep.reshape(-1, tcfg.top_k)))
        return slot, keep

    monkeypatch.setattr(TMoe, "keep_rule", record)
    tl, tc = TM.prefill(tp, t(toks).long(), tcfg, 32, seq_lens=t(lens))
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 32, seq_lens=lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    assert len(seen) == tcfg.n_layers and all(idx.shape[0] == 33 for idx, _ in seen)
    pad = torch.from_numpy((np.arange(11)[None, :] >= lens[:, None]).reshape(-1))
    behind_pads = 0
    for idx, keep in seen:
        assert int(keep[pad].sum()) > 0                      # pads took capacity
        for tok, pick in zip(*torch.nonzero(~keep & ~pad[:, None], as_tuple=True)):
            e = idx[tok, pick]
            behind_pads += int((keep[:tok] & pad[:tok, None] & (idx[:tok] == e)).sum())
    assert behind_pads > 0


def test_prefill_moe_never_sees_a_q_chunk_slice(monkeypatch):
    """With ``q_chunk`` 8 over 20 tokens the attention runs in three slices,
    but each layer's MoE gets the whole (2, 20) batch in one call."""
    _, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    moe = TMoe.moe_einsum

    def spy(p, x, cfg):
        calls.append(tuple(x.shape))
        return moe(p, x, cfg)

    monkeypatch.setattr(TMoe, "moe_einsum", spy)
    TM.prefill(tp, torch.ones((2, 20), dtype=torch.long), tcfg, 24)
    assert calls == [(2, 20, tcfg.d_model)] * tcfg.n_layers


def test_batch_prefill_lanes_pagify_into_the_pool(models):
    """A ragged two-row ``prefill`` (29 and 5 tokens) inserted lane by lane
    into a paged pool whose lanes (30 tokens) end inside a 4-token page: each
    slot's pages hold its lane's K/V up to its fill, its fill is its row's
    length, and the pool's accounting holds."""
    from repro_torch.core import kv_mapping as tkv
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.cache import CachePool

    _, tcfg, _, tp = models
    toks = np.zeros((2, 29), np.int64)
    toks[0] = np.arange(1, 30)
    toks[1, :5] = [9, 8, 7, 6, 5]
    _, cache = TM.prefill(tp, t(toks), tcfg, 30, seq_lens=t(np.asarray([29, 5])))
    cache["pos"] = t(np.asarray([29, 5]))
    pool = CachePool(tcfg, 30, 2, block_size=4, device="cpu")
    assert pool.paged
    for j, n in enumerate((29, 5)):
        si = pool.alloc(GenerationRequest(prompt=[1] * n, max_new_tokens=1), j, ctx=n)
        pool.insert(si, cache, src_slot=j)
    views = pool.views()
    assert views["pos"].tolist() == [29, 5] and pool.check_invariants() == []
    for i in range(tcfg.n_layers):
        k, v = tkv.materialize_lanes(views["k_pages"][i], views["v_pages"][i],
                                     views["block_table"])
        for j, n in enumerate((29, 5)):
            np.testing.assert_array_equal(k[j, ..., :n].numpy(), cache["k"][i, j, ..., :n].numpy())
            np.testing.assert_array_equal(v[j, :, :n].numpy(), cache["v"][i, j, :, :n].numpy())
