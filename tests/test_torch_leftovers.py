"""The port's last API leftovers against the JAX package, on the CPU.

``quant.w8a8_linear`` and ``quant_error`` (the JAX oracle path,
``use_kernel=False``), ``ServingModel.backend``/``cache_specs``/``init_pool``,
``dispatch.projected_decode_attn_bytes`` (int for int), and the fixed-mapping
KV layouts (``row_row``, ``col_col``) of ``core.kv_mapping`` beside cdpim:
cache shapes, appends, the score and output GEMVs, and the contiguous
attention step with each layout, all on the same numpy inputs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import kv_mapping as jkv  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core import kv_mapping as tkv  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402

LAYOUTS = ["cdpim", "row_row", "col_col"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


# --------------------------------------------------------------------------
# W8A8
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_w8a8_linear_and_quant_error_vs_jax(lead):
    """Bit for bit the JAX oracle path (int8 math is exact, the quantizer the
    same), and the accuracy audit to the f32 ulp."""
    r = np.random.default_rng(len(lead))
    w = (r.standard_normal((256, 512)) * 0.02).astype(np.float32)
    x = r.standard_normal((*lead, 256)).astype(np.float32)
    jy = jquant.w8a8_linear(jquant.quantize_weight(jnp.asarray(w)), jnp.asarray(x),
                            use_kernel=False)
    ty = tquant.w8a8_linear(tquant.quantize_weight(t(w)), t(x))
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    jerr = jquant.quant_error(jnp.asarray(w), jnp.asarray(x))
    terr = tquant.quant_error(t(w), t(x), device="cpu")
    assert terr == pytest.approx(jerr, rel=1e-5) and terr < 0.02
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tquant.quant_error(t(w), t(x))     # device None means the card


# --------------------------------------------------------------------------
# ServingModel
# --------------------------------------------------------------------------


def test_serving_model_backend_specs_and_pool(models):
    jcfg, tcfg, jp, tp = models
    jsm = JServing.prepare(jcfg, jp, max_len=24, slots=3)
    sm = ServingModel.prepare(tcfg, tp, max_len=24, slots=3, device="cpu")
    assert sm.backend == "reference" == jsm.backend     # the JAX CPU floor's name
    assert sm.engine().cfg.attn_backend == tcfg.attn_backend == "auto"
    k, v = sm.cache_specs["k"], sm.cache_specs["v"]
    assert k[0][-2:] == (tcfg.head_dim, 24) and v[0][-2:] == (24, tcfg.head_dim)
    assert set(sm.cache_specs) == set(jsm.cache_specs)
    for key, (shape, dtype) in sm.cache_specs.items():
        assert shape == jsm.cache_specs[key].shape, key
    for slots in (None, 5):
        jpool, pool = jsm.init_pool(slots), sm.init_pool(slots)
        assert set(pool) == set(jpool)
        for key in pool:
            assert tuple(pool[key].shape) == jpool[key].shape, key
            assert not pool[key].any(), key
        assert pool["pos"].dtype == torch.int32 and pool["pos"].device.type == "cpu"
    assert tuple(sm.init_pool()["k"].shape) == k[0]


def test_engine_refuses_meta(models):
    _, tcfg, _, _ = models
    with pytest.raises(ValueError, match="meta"):
        tdispatch.DegradationLadder(tcfg, "meta")
    assert tdispatch.resolve_backend(tcfg, "meta") == "meta"


# --------------------------------------------------------------------------
# the decode attention traffic model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dispatched", [True, False])
def test_projected_decode_attn_bytes_vs_jax(dispatched):
    kw = dict(batch=4, n_kv_heads=8, head_dim=128, lmax=8192, block_l=512)
    for pos in (1024, 4096, 8192):         # tests/test_decode_dispatch.py's case
        assert (tdispatch.projected_decode_attn_bytes(pos=pos, dispatched=dispatched, **kw)
                == jdispatch.projected_decode_attn_bytes(pos=pos, dispatched=dispatched,
                                                         **kw))
    for batch, hkv, hd, lmax, pos, bl, item in [(1, 1, 64, 100, 0, 512, 2),
                                                (3, 2, 16, 1000, 999, 128, 1),
                                                (2, 8, 128, 300, -5, 64, 4),
                                                (5, 4, 112, 4096, 4097, 256, 2)]:
        args = (batch, hkv, hd, lmax, pos)
        opts = dict(block_l=bl, itemsize=item, dispatched=dispatched)
        assert (tdispatch.projected_decode_attn_bytes(*args, **opts)
                == jdispatch.projected_decode_attn_bytes(*args, **opts))


# --------------------------------------------------------------------------
# the three KV layouts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_vs_jax(layout):
    """tests/test_kv_mapping.py's equivalence on the port, against JAX: the
    cache shapes, a ragged append at per-lane fills (bit-exact), and the
    score and output GEMVs."""
    r = np.random.default_rng(0)
    b, h, hd, lmax, tt = 2, 3, 16, 32, 4
    k_new = r.standard_normal((b, h, tt, hd)).astype(np.float32)
    v_new = r.standard_normal((b, h, tt, hd)).astype(np.float32)
    pos = np.asarray([0, 29], np.int32)            # the second window moves back to 28
    jc = jkv.init_cache(1, b, h, hd, lmax, jnp.float32, layout)
    tc = tkv.init_cache(1, b, h, hd, lmax, torch.float32, "cpu", layout)
    specs = tkv.cache_specs(1, b, h, hd, lmax, torch.float32, layout)
    assert tc["layout"] == jc["layout"] == specs["layout"] == layout
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == tuple(specs[key].shape) == jc[key].shape
        assert specs[key].device.type == "meta"
    jk, jv = jkv.append_layer(jc["k"][0], jc["v"][0], jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(pos), layout)
    tkv.append_layer(tc["k"][0], tc["v"][0], t(k_new), t(v_new), t(pos), layout)
    np.testing.assert_array_equal(tc["k"][0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc["v"][0].numpy(), np.asarray(jv))
    q = r.standard_normal((b, h, 1, 1, hd)).astype(np.float32)
    js = jkv.read_scores(jnp.asarray(q), jk, layout)
    ts = tkv.read_scores(t(q), tc["k"][0], layout)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    p = torch.softmax(ts, dim=-1)
    jo = jkv.read_output(jnp.asarray(p.numpy()), jv, layout)
    np.testing.assert_allclose(tkv.read_output(p, tc["v"][0], layout).numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="layout"):
        tkv.init_cache(1, 1, 1, 8, 8, torch.float32, "cpu", "diag")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tok", [1, 3])
def test_attention_decode_layouts_vs_jax(models, layout, tok):
    """One contiguous attention step on each layout against the JAX step at
    f32 smoke: cdpim at T == 1 takes B4's plain version, the ablation layouts
    the dense product, as in JAX; every layout gives the same output."""
    jcfg, tcfg, jp, tp = models
    b, lmax = 3, 24
    hkv, hd = jcfg.n_kv_heads, jcfg.head_dim
    r = np.random.default_rng(7)
    x = r.standard_normal((b, tok, jcfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 9, 17], np.int32)
    k = (r.standard_normal((b, hkv, lmax, hd)) * 0.5).astype(np.float32)   # row-wise
    v = (r.standard_normal((b, hkv, lmax, hd)) * 0.5).astype(np.float32)
    col = np.ascontiguousarray(np.swapaxes(k, -1, -2))
    kc, vc = {"cdpim": (col, v), "row_row": (k, v),
              "col_col": (col, np.ascontiguousarray(np.swapaxes(v, -1, -2)))}[layout]
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["attn"]
    jy, jk, jv = JA.attention_decode(lp_j, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(pos), jcfg, layout=layout)
    tk, tv = t(kc).clone(), t(vc).clone()
    ty = TA.attention_decode(tp["layers"][0]["attn"], t(x), tk, tv, t(pos), tcfg,
                             layout=layout)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    # the new K/V are products of x: an f32 ulp apart between the two GEMMs
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if layout != "cdpim":      # the same step on cdpim lanes gives the same output
        ck, cv = t(col).clone(), t(v).clone()
        y0 = TA.attention_decode(tp["layers"][0]["attn"], t(x), ck, cv, t(pos), tcfg)
        np.testing.assert_allclose(ty.numpy(), y0.numpy(), rtol=1e-5, atol=1e-6)
