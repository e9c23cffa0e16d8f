"""The port's kernel modules against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (its jnp reference, and the
Pallas kernel in interpret mode) and through the port's wrapper, which on a
CPU tensor runs its kernel's plain PyTorch version. The W8A8 GEMV and the
quantizer must agree bit for bit; attention agrees within f32 tolerances
(stated per test), because the two frameworks sum in different orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ref as jref  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention_paged_op as j_paged_op  # noqa: E402
from repro.kernels.pim_gemv import ops as jops  # noqa: E402
from repro.kernels.pim_gemv.ref import pim_gemv_ref as j_gemv_ref  # noqa: E402
from repro.kernels.pim_gemv.ref import quantize_ref as j_quantize  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as da  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention_paged_op  # noqa: E402
from repro_torch.kernels.pim_gemv import ops as tops  # noqa: E402
from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv  # noqa: E402
from repro_torch.kernels.pim_gemv.ref import quantize_ref  # noqa: E402


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# quantizer: the three places where bit identity could slip
# --------------------------------------------------------------------------

QUANT_CASES = {
    "normal": np.random.default_rng(0).standard_normal((5, 67)).astype(np.float32),
    # x / scale lands exactly on .5: half-to-even in both frameworks
    "ties": (np.array([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5]], np.float32)),
    "zeros": np.zeros((2, 9), np.float32),                     # 1e-8 scale floor
    "tiny": np.full((1, 4), 1e-12, np.float32),
    "wide": np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32) * 1e4,
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_bit_identical(case, axis):
    a = QUANT_CASES[case]
    jq, js = j_quantize(jnp.asarray(a), axis=axis)
    tq, ts = quantize_ref(t(a), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_quantize_scale_is_f32_reciprocal_multiply():
    """scale = max(amax, 1e-8) * float32(1/127), a multiply rounded in f32
    (not amax / 127, which rounds differently for some amax)."""
    r = np.random.default_rng(2)
    amax = r.uniform(0.1, 100.0, 4096).astype(np.float32)
    a = np.stack([amax, -amax / 3], axis=1)
    _, ts = quantize_ref(t(a), axis=1)
    want = amax * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), want.view(np.uint32))
    assert (want != amax / np.float32(127.0)).any()   # the two roundings differ


def test_quantize_rounds_half_to_even():
    # scale = 127 * f32(1/127) rounds to 1.0 exactly, so x/scale == x
    a = np.array([[127.0, 2.5, 3.5, -2.5, 0.5, -127.0]], np.float32)
    tq, ts = quantize_ref(t(a), axis=1)
    assert float(ts[0]) == 1.0
    assert tq.tolist() == [[127, 2, 4, -2, 0, -127]]


# --------------------------------------------------------------------------
# pim_gemv: bit-exact against the JAX reference and the Pallas kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,b", [
    (512, 1024, 1), (256, 512, 4), (384, 768, 2), (100, 130, 3), (128, 128, 8),
    (33, 47, 5),
])
def test_pim_gemv_bit_exact_vs_jax(n, k, b):
    r = np.random.default_rng(n * 7 + k)
    w = r.integers(-127, 128, (n, k)).astype(np.int8)
    x = r.integers(-127, 128, (b, k)).astype(np.int8)
    ws = (r.random(n).astype(np.float32) + 0.5) * np.float32(0.01)
    xs = (r.random(b).astype(np.float32) + 0.5) * np.float32(0.1)
    before = launch_counts()["pim_gemv"]
    out = pim_gemv(t(w), t(x), t(ws), t(xs)).numpy()
    assert launch_counts()["pim_gemv"] == before     # CPU: plain version, no launch
    ref = np.asarray(j_gemv_ref(jnp.asarray(w), jnp.asarray(x), jnp.asarray(ws),
                                jnp.asarray(xs)))
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    pallas = np.asarray(jops.pim_gemv_int8(jnp.asarray(w), jnp.asarray(x), jnp.asarray(ws),
                                           jnp.asarray(xs), block_n=64, block_k=128,
                                           interpret=True))
    np.testing.assert_array_equal(out.view(np.uint32), pallas.view(np.uint32))


@pytest.mark.parametrize("prequant", [False, True])
def test_linear_w8a8_bit_exact_vs_jax(prequant):
    r = np.random.default_rng(3)
    w = (r.standard_normal((96, 80)) * 0.02).astype(np.float32)    # (N, K)
    x = r.standard_normal((4, 80)).astype(np.float32)
    if prequant:
        wq, wsc = j_quantize(jnp.asarray(w), axis=1)
        ref = jops.linear_w8a8_prequant(wq, wsc, jnp.asarray(x), use_kernel=False)
        twq, twsc = quantize_ref(t(w), axis=1)
        out = tops.linear_w8a8_prequant(twq, twsc, t(x))
    else:
        ref = jops.linear_w8a8(jnp.asarray(w), jnp.asarray(x), use_kernel=False)
        out = tops.linear_w8a8(t(w), t(x))
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


def test_pim_gemv_rejects_mismatched_shapes():
    w = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        pim_gemv(w, torch.zeros((2, 15), dtype=torch.int8), torch.ones(8), torch.ones(2))


# --------------------------------------------------------------------------
# paged decode attention: single pass and split-KV
# --------------------------------------------------------------------------


def paged_setup(seed=7, b=3, hkv=2, g=2, hd=32, page=8, nb=8):
    """A page pool with the unused dummy at 0 and a scrambled block table."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hkv * g, hd)).astype(np.float32)
    kp = (r.standard_normal((b * nb + 1, hkv, hd, page)) * 0.3).astype(np.float32)
    vp = (r.standard_normal((b * nb + 1, hkv, page, hd)) * 0.3).astype(np.float32)
    table = (r.permutation(b * nb).reshape(b, nb) + 1).astype(np.int32)
    return q, kp, vp, table, page * nb


# f32 on both sides; XLA and torch contract q.K and p.V in different orders
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("splits", [1, 2, 4, 16])
@pytest.mark.parametrize("fill", ["full", "ragged", "window"])
def test_paged_attention_vs_jax(splits, fill):
    q, kp, vp, table, lmax = paged_setup()
    hd = q.shape[-1]
    end = {"full": [lmax, lmax, lmax], "ragged": [lmax, 9, 0],
           "window": [lmax - 3, 30, 17]}[fill]
    start = None if fill != "window" else [5, 0, 16]
    end = np.asarray(end, np.int32)
    st = None if start is None else np.asarray(start, np.int32)
    out = decode_attention_paged_op(t(q), t(kp), t(vp), t(table), t(end),
                                    start=None if st is None else t(st),
                                    scale=hd ** -0.5, num_splits=splits).numpy()
    kw = dict(start=None if st is None else jnp.asarray(st), scale=hd ** -0.5,
              num_splits=splits)
    ref = np.asarray(j_paged_op(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(table), jnp.asarray(end), use_kernel=False, **kw))
    np.testing.assert_allclose(out, ref, **TOL)
    if splits <= 4:   # the Pallas kernels in interpret mode
        pallas = np.asarray(j_paged_op(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.asarray(table), jnp.asarray(end),
                                       interpret=True, **kw))
        np.testing.assert_allclose(out, pallas, **TOL)
    for lane, e in enumerate(end):
        if e <= (0 if st is None else st[lane]):
            assert not out[lane].any()          # empty range -> exact zeros


def test_uneven_split_count_vs_pallas():
    """6 blocks in 4 requested splits: 2 blocks per split, 3 realized splits
    (the Pallas rule), checked against the Pallas kernel in interpret mode."""
    q, kp, vp, table, lmax = paged_setup(nb=6)
    hd = q.shape[-1]
    end = np.asarray([lmax, 20, 3], np.int32)
    out = decode_attention_paged_op(t(q), t(kp), t(vp), t(table), t(end),
                                    scale=hd ** -0.5, num_splits=4).numpy()
    pallas = np.asarray(j_paged_op(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(table), jnp.asarray(end), scale=hd ** -0.5,
                                   num_splits=4, interpret=True))
    np.testing.assert_allclose(out, pallas, **TOL)


@pytest.mark.parametrize("splits", [2, 3, 6])
def test_split_partials_dead_split_identity(splits):
    """Stage 1: a split outside a lane's live range is the merge identity
    (m = NEG_INF, l = 0, acc = 0); an all-dead lane merges to zeros."""
    q, kp, vp, table, lmax = paged_setup()
    b, hq, hd = q.shape
    hkv = kp.shape[1]
    qg = t(q).reshape(b, hkv, hq // hkv, hd)
    end = t(np.asarray([lmax, 5, 0], np.int32))
    acc, m, l = da.split_partials(qg, t(kp), t(vp), t(table), end, num_splits=splits,
                                  scale=hd ** -0.5)
    bps, n_real = tref.realized_splits(table.shape[1], splits)
    assert acc.shape == (b, hkv, n_real, hq // hkv, hd)
    assert bool((m[2] == tref.NEG_INF).all()) and not l[2].any() and not acc[2].any()
    dead = [si for si in range(n_real) if si * bps * kp.shape[-1] >= 5]
    assert dead and bool((l[1][:, dead] == 0).all())
    merged = da.merge_splits(acc, m, l)
    assert torch.isfinite(merged).all() and not merged[2].any()
    jm = jref.merge_splits(jnp.asarray(acc.numpy()), jnp.asarray(m.numpy()),
                           jnp.asarray(l.numpy()))
    np.testing.assert_allclose(merged.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("cap", [None, 5.0])
def test_contiguous_reference_vs_jax(cap):
    r = np.random.default_rng(4)
    b, hkv, g, hd, lmax = 2, 2, 3, 16, 40
    q = r.standard_normal((b, hkv, g, hd)).astype(np.float32)
    k = r.standard_normal((b, hkv, hd, lmax)).astype(np.float32)
    v = r.standard_normal((b, hkv, lmax, hd)).astype(np.float32)
    pos = np.asarray([lmax, 11], np.int32)
    out = tref.decode_attention_ref(t(q), t(k), t(v), t(pos), 0.25, cap).numpy()
    ref = np.asarray(jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(pos), 0.25, cap))
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_wrappers_take_plain_versions_without_launching():
    q, kp, vp, table, lmax = paged_setup()
    b, hq, hd = q.shape
    hkv = kp.shape[1]
    qg = t(q).reshape(b, hkv, hq // hkv, hd)
    end = t(np.asarray([lmax, 3, 1], np.int32))
    before = launch_counts()
    out = da.decode_attention_paged(qg, t(kp), t(vp), t(table), end, scale=0.2)
    want = tref.decode_attention_paged_ref(qg, t(kp), t(vp), t(table), end, 0.2)
    assert torch.equal(out, want)
    split = da.decode_attention_paged_split(qg, t(kp), t(vp), t(table), end,
                                            num_splits=2, scale=0.2)
    assert torch.equal(split, tref.decode_attention_paged_split_ref(
        qg, t(kp), t(vp), t(table), end, 2, 0.2))
    assert launch_counts() == before


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises. A meta tensor has neither, so every wrapper raises and
    no counter moves."""
    before = launch_counts()
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        pim_gemv(torch.empty((8, 16), dtype=torch.int8, **meta),
                 torch.empty((2, 16), dtype=torch.int8, **meta),
                 torch.empty(8, **meta), torch.empty(2, **meta))
    q = torch.empty((1, 2, 2, 16), **meta)
    kp = torch.empty((3, 2, 16, 8), **meta)
    vp = torch.empty((3, 2, 8, 16), **meta)
    table = torch.empty((1, 2), dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        da.decode_attention_paged(q, kp, vp, table, 4, scale=0.25)
    with pytest.raises(ValueError):
        da.split_partials(q, kp, vp, table, 4, num_splits=2, scale=0.25)
    with pytest.raises(ValueError):
        da.merge_splits(torch.empty((1, 2, 2, 2, 16), **meta),
                        torch.empty((1, 2, 2, 2), **meta), torch.empty((1, 2, 2, 2), **meta))
    assert launch_counts() == before
