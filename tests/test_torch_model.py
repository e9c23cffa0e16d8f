"""The port's KV mapping, weight carry-over, layers and paged decode step
against the JAX package, on the CPU at an f32 smoke size.

Page writes and gathers move bits only, so they must be bit-exact. Model
outputs agree within f32 tolerances (XLA and torch sum in other orders), and
the greedy token of every lane must be the same.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import kv_mapping as jkv  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.core import kv_mapping as tkv  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 1: np.uint8, 8: np.uint64}[a.dtype.itemsize])


# --------------------------------------------------------------------------
# paged KV mapping: bit-exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tok", [1, 5])
def test_append_layer_paged_bit_exact(tok):
    r = np.random.default_rng(tok)
    b, h, hd, bsz, nb = 3, 2, 8, 4, 5
    p = b * nb + 1
    kp = r.standard_normal((p, h, hd, bsz)).astype(np.float32)
    vp = r.standard_normal((p, h, bsz, hd)).astype(np.float32)
    k_new = r.standard_normal((b, h, tok, hd)).astype(np.float32)
    v_new = r.standard_normal((b, h, tok, hd)).astype(np.float32)
    table = (r.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
    pos = np.asarray([0, 7, 13], np.int32)
    jk, jv = jkv.append_layer_paged(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
                                    jnp.asarray(v_new), jnp.asarray(pos), jnp.asarray(table),
                                    bsz)
    tk, tv = t(kp), t(vp)
    tkv.append_layer_paged(tk, tv, t(k_new), t(v_new), t(pos), t(table), bsz)  # in place
    np.testing.assert_array_equal(bits(tk.numpy()), bits(jk))
    np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))
    jk2, jv2 = jkv.materialize_lanes(jk, jv, jnp.asarray(table))
    tk2, tv2 = tkv.materialize_lanes(tk, tv, t(table))
    np.testing.assert_array_equal(bits(tk2.numpy()), bits(jk2))
    np.testing.assert_array_equal(bits(tv2.numpy()), bits(jv2))


def test_gather_store_extract_bit_exact():
    r = np.random.default_rng(9)
    nl, p, h, hd, bsz = 2, 6, 2, 8, 4
    jpages = jkv.init_paged_cache(nl, p, h, hd, bsz, jnp.float32)
    tpages = tkv.init_paged_cache(nl, p, h, hd, bsz, torch.float32, "cpu")
    assert tuple(tpages["k_pages"].shape) == jpages["k_pages"].shape
    assert tuple(tpages["v_pages"].shape) == jpages["v_pages"].shape
    k_lane = r.standard_normal((nl, h, hd, 3 * bsz)).astype(np.float32)
    v_lane = r.standard_normal((nl, h, 3 * bsz, hd)).astype(np.float32)
    for i, phys in enumerate((4, 1, 3)):
        jkb, jvb = jkv.extract_block(jnp.asarray(k_lane), jnp.asarray(v_lane), i, bsz)
        tkb, tvb = tkv.extract_block(t(k_lane), t(v_lane), i, bsz)
        np.testing.assert_array_equal(tkb.numpy(), np.asarray(jkb))
        jpages = jkv.store_block(jpages, phys, jkb, jvb)
        tkv.store_block(tpages, phys, tkb, tvb)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(tpages[name].numpy(), np.asarray(jpages[name]))
    jk, jv = jkv.gather_pages(jpages["k_pages"], jpages["v_pages"], [4, 1, 3])
    tk, tv = tkv.gather_pages(tpages["k_pages"], tpages["v_pages"], [4, 1, 3])
    np.testing.assert_array_equal(tk.numpy(), k_lane)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_read_scores_and_output_vs_jax():
    r = np.random.default_rng(5)
    q = r.standard_normal((2, 2, 3, 4, 8)).astype(np.float32)
    k = r.standard_normal((2, 2, 8, 12)).astype(np.float32)
    v = r.standard_normal((2, 2, 12, 8)).astype(np.float32)
    s = tkv.read_scores(t(q), t(k))
    np.testing.assert_allclose(s.numpy(), np.asarray(jkv.read_scores(jnp.asarray(q),
                                                                     jnp.asarray(k))),
                               rtol=1e-5, atol=1e-5)
    p = torch.softmax(s, dim=-1)
    o = tkv.read_output(p, t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jkv.read_output(jnp.asarray(p.numpy()),
                                                                     jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)
    # the fixed-mapping baselines: row-wise K, column-wise V
    k_rows = np.ascontiguousarray(np.swapaxes(k, -1, -2))
    v_cols = np.ascontiguousarray(np.swapaxes(v, -1, -2))
    np.testing.assert_allclose(
        tkv.read_scores(t(q), t(k_rows), "row_row").numpy(),
        np.asarray(jkv.read_scores(jnp.asarray(q), jnp.asarray(k_rows), "row_row")),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tkv.read_output(p, t(v_cols), "col_col").numpy(),
        np.asarray(jkv.read_output(jnp.asarray(p.numpy()), jnp.asarray(v_cols), "col_col")),
        rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# weights, configs, layers
# --------------------------------------------------------------------------


def smoke_cfg(dtype="float32"):
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype=dtype, param_dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def test_config_copy_matches_jax():
    for smoke in (False, True):
        assert dataclasses.asdict(t_get_config("llama3-8b", smoke=smoke)) == \
            dataclasses.asdict(get_config("llama3-8b", smoke=smoke))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    """Every JAX leaf (bf16 ones arrive as ml_dtypes arrays) lands bit-exact,
    layer-stacked leaves split into one dict per layer."""
    jcfg, _ = smoke_cfg(dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert len(tp["layers"]) == jcfg.n_layers
    tdt = getattr(torch, dtype)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        arr = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(jcfg.n_layers):
                node = tp["layers"][i]
                for k in keys[1:]:
                    node = node[k]
                assert node.dtype == tdt and tuple(node.shape) == arr.shape[1:]
                np.testing.assert_array_equal(node.view(torch.int16 if dtype == "bfloat16"
                                                        else torch.int32).numpy(),
                                              arr[i].view(np.int16 if dtype == "bfloat16"
                                                          else np.int32))
        else:
            node = tp
            for k in keys:
                node = node[k]
            assert node.dtype == tdt and tuple(node.shape) == arr.shape


def test_init_params_matches_jax_structure_and_scale():
    jcfg, tcfg = smoke_cfg()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jl = {jax.tree_util.keystr(p): np.asarray(v)[0]
          for p, v in jax.tree_util.tree_flatten_with_path(jp["layers"])[0]}
    for i in range(tcfg.n_layers):
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + f"['{k}']")
                else:
                    flat[prefix + f"['{k}']"] = v
        walk(tp["layers"][i], "")
        assert set(flat) == set(jl)
        for key, v in flat.items():
            assert tuple(v.shape) == jl[key].shape
            # the same distribution: N(0, 1/fan_in) for matrices, ones for norms
            assert abs(float(v.float().std()) - float(jl[key].std())) < 0.2 * float(
                jl[key].std()) + 1e-6
    for key in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[key][next(iter(tp[key]))].shape) == np.asarray(
            next(iter(jp[key].values()))).shape


def test_device_rule_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = smoke_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(tcfg, torch.Generator())


def test_rmsnorm_rope_mlp_vs_jax():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    scale = r.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm({"scale": t(scale)}, t(x)).numpy(),
                               np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)},
                                                     jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    q = r.standard_normal((2, 4, 3, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2], [7, 8, 9]], np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(t(q), t(pos)[:, None, :], 500000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos)[:, None, :], 500000.0)),
        rtol=1e-5, atol=1e-5)
    w = {k: (r.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    np.testing.assert_allclose(
        TL.mlp({k: t(v) for k, v in w.items()}, t(x)).numpy(),
        np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def test_prepare_decode_params_matches_jax():
    jcfg, _ = smoke_cfg()
    from repro.core import quant as jquant
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jprep = jquant.prepare_decode_params(jp)
    tprep = tquant.prepare_decode_params(tp)
    for i in range(jcfg.n_layers):
        for sub, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down")):
            tl = tprep["layers"][i][sub][name]
            jl = jprep["layers"][sub][name]
            assert isinstance(tl, tquant.PreparedLinear)
            np.testing.assert_array_equal(tl.w_q.numpy(), np.asarray(jl.w_q)[i])
            np.testing.assert_array_equal(bits(tl.w_scale.numpy()), bits(np.asarray(jl.w_scale)[i]))
            assert tquant.raw_weight(tl) is tp["layers"][i][sub][name]
    assert tprep["embed"]["w"] is tp["embed"]["w"]      # unmatched leaves are shared


# --------------------------------------------------------------------------
# the paged decode step
# --------------------------------------------------------------------------


def paged_cache(cfg, b, nb, bsz, pos, seed):
    """A filled page pool with a scrambled block table, as numpy."""
    r = np.random.default_rng(seed)
    p = b * nb + 1
    k = (r.standard_normal((cfg.n_layers, p, cfg.n_kv_heads, cfg.head_dim, bsz)) * 0.5)
    v = (r.standard_normal((cfg.n_layers, p, cfg.n_kv_heads, bsz, cfg.head_dim)) * 0.5)
    table = (r.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
    return {"k_pages": k.astype(np.float32), "v_pages": v.astype(np.float32),
            "block_table": table, "pos": np.asarray(pos, np.int32)}


@pytest.fixture(scope="module")
def f32_model():
    jcfg, tcfg = smoke_cfg()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("tok", [1, 4])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("splits", [1, 2])
def test_paged_decode_step_vs_jax(f32_model, tok, quantized, splits):
    jcfg, tcfg, jp, tp = f32_model
    jcfg = jcfg.replace(quantized_decode=quantized, decode_kv_splits=splits)
    tcfg = tcfg.replace(quantized_decode=quantized, decode_kv_splits=splits)
    c = paged_cache(jcfg, b=3, nb=6, bsz=4, pos=[0, 9, 17], seed=tok)
    tokens = np.random.default_rng(11).integers(1, jcfg.vocab_size, (3, tok)).astype(np.int32)
    jlog, jcache = JM.decode_step(jp, {k: jnp.asarray(v) for k, v in c.items()},
                                  jnp.asarray(tokens), jcfg)
    tcache = {k: t(v) for k, v in c.items()}
    k_before = tcache["k_pages"]
    tlog, tcache2 = TM.decode_step(tp, tcache, t(tokens).long(), tcfg)
    assert tcache2["k_pages"] is k_before              # written in place, not copied
    assert tcache2["pos"].tolist() == (c["pos"] + tok).tolist()
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
    np.testing.assert_allclose(tcache2["k_pages"].numpy(), np.asarray(jcache["k_pages"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcache2["v_pages"].numpy(), np.asarray(jcache["v_pages"]),
                               rtol=1e-5, atol=1e-5)


def test_decode_step_refuses_unknown_family_and_decodes_rwkv6_state(f32_model):
    """Every family of the JAX package is ported now (contiguous dense lanes
    in tests/test_torch_contiguous.py, rwkv6 in tests/test_torch_rwkv.py):
    what is still refused is a family outside ``FAMILIES``, as the JAX
    ``init_params`` refuses it; rwkv6's contiguous state cache decodes, and
    the dense contiguous cache still does."""
    jcfg, tcfg, _, tp = f32_model
    bogus = tcfg.replace(family="diffusion")
    with pytest.raises(ValueError, match="diffusion"):
        JM.init_params(jax.random.PRNGKey(0), jcfg.replace(family="diffusion"))
    for call in (lambda: TM.init_params(bogus, torch.Generator(), device="cpu"),
                 lambda: TM.init_decode_cache(bogus, 1, 16, device="cpu"),
                 lambda: TM.decode_step(tp, TM.init_decode_cache(tcfg, 1, 16, device="cpu"),
                                        torch.zeros((1, 1), dtype=torch.long), bogus)):
        with pytest.raises(ValueError, match="diffusion"):
            call()
    rcfg = t_get_config("rwkv6-1.6b", smoke=True).replace(dtype="float32",
                                                         param_dtype="float32")
    rp = TM.init_params(rcfg, torch.Generator().manual_seed(0), device="cpu")
    rcache = TM.init_decode_cache(rcfg, 2, 16, device="cpu")
    assert set(rcache) == {"wkv", "att_tail", "ffn_tail", "pos"}
    logits, rcache = TM.decode_step(rp, rcache, torch.ones((2, 1), dtype=torch.long), rcfg)
    assert logits.shape == (2, 1, rcfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert int(rcache["pos"]) == 1 and rcache["wkv"].abs().sum() > 0
    cache = TM.init_decode_cache(tcfg, 1, 16, device="cpu")
    _, cache = TM.decode_step(tp, cache, torch.ones((1, 1), dtype=torch.long), tcfg)
    assert int(cache["pos"]) == 1
