"""The port's Mamba2 block and SSD scan against the JAX package, on the CPU.

Kernel B5 (SSD chunked scan): its plain version (the sequential recurrence)
and the op's pad path against JAX ``ssd_scan_ref`` and the Pallas kernel in
interpret mode; the kernel's own arithmetic (``ssd_subchunk_ref``: sub-chunks
of 32, operands in TF32 pieces) against both, showing that three TF32 pieces
meet the f32 tolerance and one does not. The model's own chunked scan (``ssd_chunked``, plain PyTorch
in both packages) against JAX ``ssd_chunked``, and its chunk invariance.
Then ``ssm_forward`` / ``ssm_decode_step`` against JAX at an f32 smoke size.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan_op as j_scan_op  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_scan_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import pad_to_chunk, ssd_scan_op  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_ref, ssd_subchunk_ref, tf32_round)
from repro_torch.models import ssm as tssm  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))      # a writable copy


def scan_inputs(b, t_len, h, p, n, seed=3, s0=True):
    """The JAX package's own test distribution (tests/test_kernels.py)."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((b, t_len, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(r.standard_normal((b, t_len, h))) * 0.3).astype(np.float32)
    bm = (r.standard_normal((b, t_len, n)) * 0.5).astype(np.float32)
    cm = (r.standard_normal((b, t_len, n)) * 0.5).astype(np.float32)
    st = (r.standard_normal((b, h, p, n)) * 0.1).astype(np.float32) if s0 else None
    return x, a, bm, cm, st


# f32 on both sides; the chunked forms sum the same terms in other orders and
# take exp of cumulative log decays where the recurrence multiplies per step
TOL = dict(rtol=1e-4, atol=1e-4)

SCAN_CASES = [(2, 64, 3, 16, 8, 16), (1, 100, 2, 32, 16, 32),   # 100 % 32: the pad path
              (2, 32, 1, 64, 64, 32), (1, 13, 2, 8, 4, 8)]


@pytest.mark.parametrize("b,t_len,h,p,n,q", SCAN_CASES)
def test_ssd_scan_plain_and_op_vs_jax(b, t_len, h, p, n, q):
    x, a, bm, cm, s0 = scan_inputs(b, t_len, h, p, n)
    jargs = [jnp.asarray(v) for v in (x, a, bm, cm, s0)]
    jy, js = j_scan_ref(*jargs)
    ty, ts = ssd_scan_ref(*(t(v) for v in (x, a, bm, cm, s0)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # the op's kernel path on the CPU: pad to the chunk, the wrapper's plain
    # version, cut back; against the Pallas kernel in interpret mode
    before = launch_counts()
    oy, os_ = ssd_scan_op(*(t(v) for v in (x, a, bm, cm, s0)), chunk=q)
    assert launch_counts() == before
    py, ps = j_scan_op(*jargs, chunk=q, interpret=True)
    assert tuple(oy.shape) == (b, t_len, h, p)
    np.testing.assert_allclose(oy.numpy(), np.asarray(py), **TOL)
    np.testing.assert_allclose(os_.numpy(), np.asarray(ps), **TOL)


def test_pad_to_chunk_is_zero_decay():
    """Padding appends a = x = b = c = 0 steps: the real steps' outputs do not
    move, the state passes through the padding unchanged, and the padded
    outputs are exact zeros (c = 0)."""
    x, a, bm, cm, _ = scan_inputs(1, 13, 2, 8, 4, seed=9, s0=False)
    xp, ap, bp, cp = pad_to_chunk(t(x), t(a), t(bm), t(cm), 8)
    assert xp.shape[1] == ap.shape[1] == bp.shape[1] == cp.shape[1] == 16
    assert not xp[:, 13:].any() and not ap[:, 13:].any() and not cp[:, 13:].any()
    s0 = torch.zeros((1, 2, 8, 4))
    y, s = ssd_scan_ref(t(x), t(a), t(bm), t(cm), s0)
    yp, sp = ssd_scan_ref(xp, ap, bp, cp, s0)
    assert torch.equal(yp[:, :13], y) and torch.equal(sp, s) and not yp[:, 13:].any()
    assert pad_to_chunk(t(x), t(a), t(bm), t(cm), 13)[0].shape[1] == 13


@pytest.mark.parametrize("t_len,chunk", [(16, 8), (48, 16), (64, 32), (13, 8), (24, 64)])
def test_ssd_chunked_vs_jax_and_chunk_invariance(t_len, chunk):
    """The model's chunked scan: against JAX ``ssd_chunked`` at the same chunk,
    and against the sequential recurrence whatever the chunk (associativity);
    13 % 8 != 0 scans as one chunk, as in the JAX package."""
    x, a, bm, cm, s0 = scan_inputs(2, t_len, 2, 8, 4, seed=t_len + chunk)
    ty, ts = tssm.ssd_chunked(t(x), t(a), t(bm), t(cm), chunk, t(s0))
    jy, js = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bm),
                              jnp.asarray(cm), chunk, jnp.asarray(s0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    ry, rs = ssd_scan_ref(t(x), t(a), t(bm), t(cm), t(s0))
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), rs.numpy(), rtol=2e-4, atol=2e-4)
    zy, _ = tssm.ssd_chunked(t(x), t(a), t(bm), t(cm), chunk)   # s0 None -> zeros
    wy, _ = ssd_scan_ref(t(x), t(a), t(bm), t(cm), torch.zeros_like(t(s0)))
    np.testing.assert_allclose(zy.numpy(), wy.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_scan_wrapper_refuses_meta_tensors():
    before = launch_counts()
    x, a, bm, cm, s0 = (torch.empty(s, device="meta") for s in
                        ((1, 8, 2, 4), (1, 8, 2), (1, 8, 3), (1, 8, 3), (1, 2, 4, 3)))
    with pytest.raises(ValueError):
        ss.ssd_scan(x, a, bm, cm, s0, chunk=8)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, a[:, :4], bm, cm, s0, chunk=8)      # shape mismatch
    assert launch_counts() == before
    # the walk block's shared memory lets four blocks share an H100 SM (228 KB,
    # 1 KB of it reserved a block), whatever the chunk or P
    assert 4 * (ss.smem_bytes() + 1024) <= 233472


# the kernel's arithmetic on the CPU: SCAN_CASES at the JAX test's decays, then
# zamba2's P = N = 64 over T 2048 at those decays and three times stronger, and
# with no decay over T 512 (over T 2048 without decay the f32 references drift
# from the exact recurrence by most of the tolerance themselves: see
# test_ssd_subchunk_without_decay_matches_the_f64_recurrence)
SUB_CASES = ([(*case, 1.0) for case in SCAN_CASES]
             + [(1, 2048, 2, 64, 64, 256, scale) for scale in (1.0, 3.0)]
             + [(1, 512, 2, 64, 64, 256, 0.0)])


def sub_inputs(b, t_len, h, p, n, scale):
    x, a, bm, cm, s0 = scan_inputs(b, t_len, h, p, n, seed=t_len + p)
    return x, (a * np.float32(scale)).astype(np.float32), bm, cm, s0


def close(got, want) -> bool:
    return all(np.allclose(g.numpy().astype(np.float64), np.asarray(w), **TOL)
               for g, w in zip(got, want))


@pytest.mark.parametrize("b,t_len,h,p,n,q,scale", SUB_CASES)
def test_ssd_subchunk_three_tf32_pieces_match_jax(b, t_len, h, p, n, q, scale):
    """The CUDA kernel's precision scheme, emulated: sub-chunks of the kernel's
    own size and every chunked product as lo*hi + hi*lo + hi*hi of TF32
    pieces, against JAX ``ssd_scan_ref`` and the Pallas kernel in interpret
    mode at the caller's chunk, at the unchanged f32 tolerance."""
    ops = sub_inputs(b, t_len, h, p, n, scale)
    jargs = [jnp.asarray(v) for v in ops]
    got = ssd_subchunk_ref(*(t(v) for v in ops), sub_chunk=ss.SUB_CHUNK, tf32_pieces=3)
    assert tuple(got[0].shape) == (b, t_len, h, p) and tuple(got[1].shape) == (b, h, p, n)
    for want in (j_scan_ref(*jargs), j_scan_op(*jargs, chunk=q, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("b,t_len,h,p,n,q,scale", SUB_CASES)
def test_ssd_subchunk_one_tf32_piece_fails(b, t_len, h, p, n, q, scale):
    """One TF32 piece (11 significant bits, about 5e-4 relative) misses the f32
    tolerance on the same inputs where f32 products meet it: the reason the
    kernel takes three pieces."""
    ops = sub_inputs(b, t_len, h, p, n, scale)
    want = j_scan_ref(*[jnp.asarray(v) for v in ops])
    tops = [t(v) for v in ops]
    assert close(ssd_subchunk_ref(*tops, sub_chunk=ss.SUB_CHUNK), want)
    assert not close(ssd_subchunk_ref(*tops, sub_chunk=ss.SUB_CHUNK, tf32_pieces=1), want)


def test_ssd_subchunk_without_decay_matches_the_f64_recurrence():
    """a = 0 over T 2048: the state sums 2048 outer products and an f32
    sequential recurrence lands near the edge of the tolerance from the exact
    result; three TF32 pieces stay within the tolerance of the recurrence
    taken in f64, and one piece does not."""
    x, a, bm, cm, s0 = sub_inputs(1, 2048, 2, 64, 64, 0.0)
    s = torch.from_numpy(s0).double()
    xd, bd, cd = (torch.from_numpy(v).double() for v in (x, bm, cm))
    ys = []
    for i in range(x.shape[1]):                 # a = 0: no decay
        s = s + torch.einsum("bhp,bn->bhpn", xd[:, i], bd[:, i])
        ys.append(torch.einsum("bhpn,bn->bhp", s, cd[:, i]))
    want = (torch.stack(ys, dim=1).numpy(), s.numpy())
    tops = [t(v) for v in (x, a, bm, cm, s0)]
    assert close(ssd_subchunk_ref(*tops, sub_chunk=ss.SUB_CHUNK, tf32_pieces=3), want)
    assert not close(ssd_subchunk_ref(*tops, sub_chunk=ss.SUB_CHUNK, tf32_pieces=1), want)


@pytest.mark.parametrize("sub_chunk", [1, 8, 24, 64])
def test_ssd_subchunk_result_does_not_depend_on_the_sub_chunk(sub_chunk):
    """Any sub-chunk, a ragged one (100 % 24 != 0) included, gives the
    recurrence's result within the tolerance."""
    ops = [t(v) for v in scan_inputs(2, 100, 3, 16, 8, seed=sub_chunk)]
    want = ssd_scan_ref(*ops)
    for pieces in (None, 3):
        got = ssd_subchunk_ref(*ops, sub_chunk=sub_chunk, tf32_pieces=pieces)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 stored mantissa bits, rounding to nearest with
    ties away from zero as ``cvt.rna.tf32.f32`` does."""
    ulp = 2.0 ** -10                                    # TF32's unit at [1, 2)
    vals = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                         1.5 + ulp / 2 - 2.0 ** -20, 3.0e-3, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 1.5, 3.0e-3, 0.0],
                        dtype=torch.float32)
    got = tf32_round(vals)
    assert torch.equal(got[:6], want[:6]) and got[7] == 0.0
    assert not (got.view(torch.int32) & 0x1FFF).any()
    assert abs(float(got[6]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


# --------------------------------------------------------------------------
# the Mamba2 block
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    jcfg = get_config("zamba2-7b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = jssm.init_ssm(jax.random.PRNGKey(4), jcfg)
    tp = jax.tree_util.tree_map(lambda v: t(v), jp)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def state_inputs(cfg, b, seed):
    r = np.random.default_rng(seed)
    _, d_inner, n_heads = jssm.ssm_dims(cfg)
    return {"ssd": (r.standard_normal((b, n_heads, cfg.ssm_head_dim, cfg.ssm_state))
                    * 0.1).astype(np.float32),
            "conv_x": (r.standard_normal((b, cfg.ssm_conv_width - 1, d_inner))
                       * 0.5).astype(np.float32),
            "conv_bc": (r.standard_normal((b, cfg.ssm_conv_width - 1, 2 * cfg.ssm_state))
                        * 0.5).astype(np.float32)}


@pytest.mark.parametrize("t_len,with_state", [(1, True), (4, True), (13, True), (16, False)])
def test_ssm_forward_vs_jax(block, t_len, with_state):
    """T = 1 is the decode recurrence; T = 13 is not a multiple of the smoke
    chunk (8), so both packages scan it as one chunk."""
    jcfg, tcfg, jp, tp = block
    r = np.random.default_rng(t_len)
    x = r.standard_normal((2, t_len, jcfg.d_model)).astype(np.float32)
    st = state_inputs(jcfg, 2, t_len) if with_state else None
    jy, jst = jssm.ssm_forward(jp, jnp.asarray(x), jcfg,
                               None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = tssm.ssm_forward(tp, t(x), tcfg,
                               None if st is None else {k: t(v) for k, v in st.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    for key in ("ssd", "conv_x", "conv_bc"):
        assert tst[key].dtype == torch.float32
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), rtol=1e-4,
                                   atol=1e-5)
    if t_len == 1:
        dy, dst = tssm.ssm_decode_step(tp, t(x), {k: t(v) for k, v in st.items()}, tcfg)
        assert torch.equal(dy, ty) and all(torch.equal(dst[k], tst[k]) for k in dst)


def test_ssm_decode_steps_equal_one_forward(block):
    """Token by token from a state equals one pass over the sequence: the
    recurrence the decode cache carries is the scan's."""
    _, tcfg, _, tp = block
    x = t(np.random.default_rng(8).standard_normal((1, 6, tcfg.d_model)).astype(np.float32))
    y_all, st_all = tssm.ssm_forward(tp, x, tcfg)
    st = tssm.init_ssm_state(1, tcfg.replace(dtype="float32"), device="cpu")
    ys = []
    for i in range(6):
        y, st = tssm.ssm_decode_step(tp, x[:, i:i + 1], st, tcfg)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st["ssd"].numpy(), st_all["ssd"].numpy(), rtol=1e-4, atol=1e-5)


def test_init_ssm_and_state_match_jax(block):
    jcfg, tcfg, jp, _ = block
    tp = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert set(tp) == set(jp)
    for key, leaf in jp.items():
        if isinstance(leaf, dict):
            assert tuple(tp[key]["scale"].shape) == leaf["scale"].shape
            continue
        assert tuple(tp[key].shape) == leaf.shape, key
    for key in ("dt_bias", "d_skip"):                  # deterministic leaves: exact
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    # log(linspace(1, H, H)): the two libraries' f32 log may differ by an ulp
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]), rtol=2e-7)
    js = jssm.init_ssm_state(3, jcfg)
    ts = tssm.init_ssm_state(3, tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}
    assert ts["ssd"].dtype == torch.float32
