"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test asks for a CUDA device and skips without one. On a
machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def gemv_operands(n, k, b, gen, dev):
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    x = torch.randint(-127, 128, (b, k), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=gen, device=dev) + 0.01
    xs = torch.rand((b,), generator=gen, device=dev) + 0.01
    return w, x, ws, xs


# distinct (N, K) of the W8A8 decode GEMVs the serves launch: llama3-8b,
# internvl2-2b, seamless-m4t-large-v2, yi-9b, codeqwen1.5-7b (olmoe's and
# phi3.5-moe's are among them)
SERVE_GEMV = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
              (2048, 2048), (1024, 2048), (8192, 2048), (2048, 8192),
              (1024, 1024), (8192, 1024), (1024, 8192),
              (512, 4096), (11008, 4096), (4096, 11008), (13440, 4096), (4096, 13440)]


def _gemv_exact(n, k, b, gen, dev, x=None):
    """One call against the plain version, bit for bit, and exactly one launch."""
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv
    from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref

    w, x0, ws, xs = gemv_operands(n, k, b, gen, dev)
    x = x0 if x is None else x
    before = pim_gemv.launches
    out = pim_gemv(w, x, ws, xs)
    torch.cuda.synchronize()
    assert pim_gemv.launches == before + 1
    assert torch.equal(out, pim_gemv_ref(w, x, ws, xs))


@pytest.mark.parametrize("n,k,b", [(1, 16, 1), (37, 64, 3), (256, 1000, 8), (1024, 4096, 4),
                                   (300, 14336, 8), (5, 7, 2),
                                   # long K: gemma2-27b's w_down, and an odd one
                                   (4096, 36864, 8), (257, 36870, 5), (4096, 36864, 17),
                                   # batch groups past 8 rows
                                   (1024, 4096, 16), (300, 4100, 11), (96, 36864, 17),
                                   (4096, 4096, 9), (14336, 4096, 17),
                                   # zeros read past a ragged N and K; one tile
                                   (1000, 4112, 5), (64, 128, 1),
                                   # an odd K (the plain kernel) at the check's ragged shape
                                   (3001, 4100, 1), (3001, 4100, 4), (3001, 4100, 8),
                                   (3001, 4100, 16)] +
                         [(n, k, b) for n, k in SERVE_GEMV for b in (1, 4, 8)])
def test_pim_gemv_bit_exact(dev, gen, n, k, b):
    """Every serve shape at B 1, 4, 8 and shapes past them; the path the
    kernel takes: the tensor cores where the copy engine can read the
    operands (K % 16 == 0, K >= 128, N >= 64), else the plain kernel."""
    from repro_torch.kernels.pim_gemv.pim_gemv import plan

    p = plan(n, k, b)
    assert p["tensor_cores"] == (k % 16 == 0 and k >= 128 and n >= 64)
    assert p["groups"] == -(-b // 8)
    _gemv_exact(n, k, b, gen, dev)


@pytest.mark.parametrize("n,k,b", [(64, 128, 2), (4096, 4096, 4), (1024, 4096, 8)])
def test_pim_gemv_unaligned_activation_takes_the_byte_path(dev, gen, n, k, b):
    """x one byte off a 16-byte boundary: the copy engine cannot read it, so
    the plain kernel runs, bit-exact."""
    from repro_torch.kernels.pim_gemv.pim_gemv import plan

    buf = torch.randint(-127, 128, (b * k + 1,), generator=gen, device=dev, dtype=torch.int8)
    assert not plan(n, k, b, vec=False)["tensor_cores"]
    _gemv_exact(n, k, b, gen, dev, x=buf[1:].view(b, k))


def test_pim_gemv_refuses_bad_operands(dev, gen):
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv

    w, x, ws, xs = gemv_operands(8, 32, 2, gen, dev)
    with pytest.raises(TypeError):
        pim_gemv(w.float(), x, ws, xs)
    with pytest.raises(ValueError):              # one scale per batch row
        pim_gemv(w, x, ws, xs[:1])


def paged(gen, dev, b, hkv, g, hd, bsz, nb, dtype):
    p = b * nb + 1
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(dtype)
    kp = (torch.randn((p, hkv, hd, bsz), generator=gen, device=dev) * 0.3).to(dtype)
    vp = (torch.randn((p, hkv, bsz, hd), generator=gen, device=dev) * 0.3).to(dtype)
    table = (torch.randperm(b * nb, generator=gen, device=dev) + 1).reshape(b, nb)
    return q, kp, vp, table.to(torch.int32)


# f32 accumulation on both sides, summed in other orders (online softmax)
TOL = dict(rtol=1e-4, atol=1e-5)


def live_ranges(lmax, edges, dev):
    """(end, start) per lane. ``edges=False``: a full lane, a ragged one, an empty
    one and one with start > 0. ``edges=True``: ranges that start and end inside
    one 16-byte vector (8 bf16 tokens) and inside one 256-token chunk, one that
    crosses chunks from inside a vector, and the empty lane."""
    if edges:
        end, start = [13, lmax - 3, 0, 270], [3, 250, 0, 261]
    else:
        end, start = [lmax, lmax // 3 + 1, 0, lmax - 1], [0, 0, 0, max(1, lmax // 2)]
    return (torch.tensor(end, dtype=torch.int32, device=dev),
            torch.tensor(start, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("g,hd,bsz,nb,dtype,cap,edges", [
    (4, 128, 8, 12, torch.bfloat16, None, False), (1, 64, 16, 12, torch.float32, None, False),
    (16, 256, 48, 12, torch.bfloat16, 30.0, False), (3, 32, 1, 12, torch.float32, None, False),
    (2, 128, 64, 12, torch.float32, 5.0, False),
    (4, 128, 8, 100, torch.bfloat16, None, True),     # 800 tokens: 4 chunks
    (1, 112, 8, 100, torch.bfloat16, 30.0, True),
    (4, 128, 64, 40, torch.bfloat16, None, True),     # 2560 tokens in pages of 64
    (4, 128, 8, 256, torch.bfloat16, None, False),    # lanes of 8 chunks
    (4, 128, 8, 37, torch.bfloat16, None, False),     # the paged llama3-8b serve's tables
    (4, 128, 8, 14, torch.bfloat16, None, False)])    # the spec serve's (max_len + slack)
def test_paged_decode_matches_plain(dev, gen, g, hd, bsz, nb, dtype, cap, edges):
    """B1, and B2 at 2, 4, 5 and 64 splits (4 splits of the 37-block tables are
    80 tokens each, cut mid-tile)."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv = 4, 2
    q, kp, vp, table = paged(gen, dev, b, hkv, g, hd, bsz, nb, dtype)
    end, start = live_ranges(nb * bsz, edges, dev)
    out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=hd ** -0.5,
                                    softcap=cap)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, hd ** -0.5, cap,
                                          start=start)
    torch.testing.assert_close(out, want, **TOL)
    assert not out[2].any()
    for s in (2, 4, 5, 64):
        acc, m, l = da.split_partials(q, kp, vp, table, end, start, num_splits=s,
                                      scale=hd ** -0.5, softcap=cap)
        racc, rm, rl = ref.split_partials_ref(q, kp, vp, table, end, s, hd ** -0.5, cap,
                                              start=start)
        for a, r in ((acc, racc), (m, rm), (l, rl)):
            torch.testing.assert_close(a, r, **TOL)
        merged = da.merge_splits(acc, m, l)
        torch.testing.assert_close(merged, ref.merge_splits(acc, m, l), **TOL)
        torch.testing.assert_close(merged, want, **TOL)
        assert not merged[2].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])   # tensor / CUDA cores
@pytest.mark.parametrize("nb,splits,end,start,cap", [
    # 4 splits of 80 tokens: lane 0 starts at 70, so the boundary at 80 falls inside
    # its first tile [64, 96); lane 1 leaves three splits dead; lane 2 is all dead;
    # lane 3 lives in split 2 only, from inside a tile to inside another
    (37, 4, [296, 45, 0, 239], [70, 0, 0, 161], 30.0),
    # 4 splits of 512 tokens (two chunks each) at the kernel-bench fills
    (256, 4, [2048, 777, 0, 300], [0, 0, 0, 100], None),
    # 3 realized splits of 104, 104 and 88 tokens, each boundary mid-tile
    (37, 3, [296, 100, 0, 296], [1, 99, 0, 200], None)])
def test_split_partials_match_plain(dev, gen, dtype, nb, splits, end, start, cap):
    """B2 stage 1 and the merge against their plain versions on both walks, with
    dead splits (the exact identity partial), an all-dead lane (zeros after the
    merge), a softcap and start > 0; one launch of each wrapper."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv, g, hd, bsz = 4, 2, 4, 128, 8
    q, kp, vp, table = paged(gen, dev, b, hkv, g, hd, bsz, nb, dtype)
    end = torch.tensor(end, dtype=torch.int32, device=dev)
    start = torch.tensor(start, dtype=torch.int32, device=dev)
    before = (da.split_partials.launches, da.merge_splits.launches)
    acc, m, l = da.split_partials(q, kp, vp, table, end, start, num_splits=splits,
                                  scale=hd ** -0.5, softcap=cap)
    merged = da.merge_splits(acc, m, l)
    torch.cuda.synchronize()
    assert (da.split_partials.launches, da.merge_splits.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    racc, rm, rl = ref.split_partials_ref(q, kp, vp, table, end, splits, hd ** -0.5, cap,
                                          start=start)
    assert acc.shape == racc.shape and m.shape == rm.shape and l.shape == rl.shape
    for a, r in ((acc, racc), (m, rm), (l, rl)):
        torch.testing.assert_close(a, r, **TOL)
    dead = rl == 0
    assert dead.any() and not dead.all()
    assert bool((l[dead] == 0).all()) and bool((m[dead] == ref.NEG_INF).all())
    assert not acc[dead].any()
    torch.testing.assert_close(merged, ref.merge_splits(racc, rm, rl), **TOL)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, hd ** -0.5, cap, start=start)
    torch.testing.assert_close(merged, want, **TOL)
    assert not merged[2].any() and not merged.isnan().any()


def test_attention_refuses_unsupported_shapes(dev, gen):
    from repro_torch.kernels.decode_attention import decode_attention as da

    q, kp, vp, table = paged(gen, dev, 1, 1, 17, 32, 8, 2, torch.float32)
    with pytest.raises(ValueError):
        da.decode_attention_paged(q, kp, vp, table, 4, scale=0.1)
    q, kp, vp, table = paged(gen, dev, 1, 1, 2, 32, 8, 2, torch.float16)
    with pytest.raises(TypeError):
        da.decode_attention_paged(q, kp, vp, table, 4, scale=0.1)


def test_serve_on_the_card_goes_through_every_kernel(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import init_params
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.serving_model import ServingModel

    cfg = get_config("llama3-8b", smoke=True).replace(quantized_decode=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    reqs = [GenerationRequest(prompt=list(range(1, 2 + 3 * i)), max_new_tokens=4 + i)
            for i in range(5)]
    reset_launches()
    outs = {}
    for splits in (1, 2):
        sm = ServingModel.prepare(cfg.replace(decode_kv_splits=splits), params, max_len=64,
                                  slots=2)
        for mode in (Mode.BLOCKED, Mode.HBCEM, Mode.LBIM):
            eng = sm.engine(mode=mode, chunk=4)
            outs[(splits, mode)] = [r.tokens for r in eng.serve(reqs)]
            assert eng.pool.check_invariants() == []
    for splits in (1, 2):
        assert outs[(splits, Mode.HBCEM)] == outs[(splits, Mode.BLOCKED)]
        assert outs[(splits, Mode.LBIM)] == outs[(splits, Mode.BLOCKED)]
    paged_path = ("pim_gemv", "decode_attention_paged", "decode_attention_paged_split",
                  "merge_splits")
    assert all(launch_counts()[k] > 0 for k in paged_path)


def contiguous(gen, dev, b, hkv, g, hd, lmax, dtype):
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev).to(dtype)
    k = (torch.randn((b, hkv, hd, lmax), generator=gen, device=dev) * 0.3).to(dtype)
    v = (torch.randn((b, hkv, lmax, hd), generator=gen, device=dev) * 0.3).to(dtype)
    return q, k, v


@pytest.mark.parametrize("g,hd,lmax,dtype,cap,edges", [
    (4, 128, 2048, torch.bfloat16, None, False), (1, 112, 300, torch.bfloat16, None, False),
    (1, 112, 77, torch.float32, 50.0, False), (16, 256, 130, torch.bfloat16, 30.0, False),
    (3, 32, 9, torch.float32, None, False),
    (1, 112, 600, torch.bfloat16, None, True), (4, 128, 600, torch.bfloat16, 30.0, True),
    (1, 112, 301, torch.bfloat16, None, True),      # Lmax % 8 != 0: the plain-load path
    (1, 112, 2051, torch.bfloat16, None, False),    # ragged and longer than 8 chunks
    (16, 256, 1100, torch.float32, None, True),
    (1, 112, 128, torch.bfloat16, None, False),     # the zamba2-7b serve's Lmax: one chunk
    (4, 128, 256, torch.bfloat16, None, False),     # one full chunk on the tensor cores
    (4, 128, 296, torch.bfloat16, 30.0, False),     # the contiguous llama3-8b serve's Lmax
    (4, 128, 109, torch.bfloat16, None, False)])    # the spec serve's draft lanes
def test_contiguous_decode_matches_plain(dev, gen, g, hd, lmax, dtype, cap, edges):
    """B4: llama3-8b (G 4, hd 128) and zamba2 (G 1, hd 112) shapes, an empty
    range, a start > 0, a softcap, the wide instantiation, ranges inside one
    16-byte vector and inside one chunk, and lanes of several chunks."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv = 4, 2
    q, k, v = contiguous(gen, dev, b, hkv, g, hd, lmax, dtype)
    end, start = live_ranges(lmax, edges, dev)
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, end, start, scale=hd ** -0.5, softcap=cap)
    want = ref.decode_attention_ref(q, k, v, end, hd ** -0.5, cap, start=start)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(out, want, **TOL)
    assert not out[2].any()


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("g,hd,span", [(4, 128, 2048), (1, 112, 1000), (1, 112, 128),
                                       (4, 128, 112)])
def test_single_pass_is_batch_invariant(dev, gen, layout, g, hd, span):
    """B1 and B4: each lane of a batch of 4 with other fills gives the same bits
    as the lane computed alone (B = 1), at the same table width or Lmax."""
    from repro_torch.kernels.decode_attention import decode_attention as da

    b, hkv, bsz = 4, 2, 8
    end = torch.tensor([span, span // 3 + 5, 0, span - 7], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 3, 0, span // 2 + 1], dtype=torch.int32, device=dev)
    if layout == "paged":
        q, kp, vp, table = paged(gen, dev, b, hkv, g, hd, bsz, span // bsz, torch.bfloat16)

        def run(i):
            return da.decode_attention_paged(q[i], kp, vp, table[i], end[i], start[i],
                                             scale=hd ** -0.5)
    else:
        q, k, v = contiguous(gen, dev, b, hkv, g, hd, span, torch.bfloat16)

        def run(i):
            return da.decode_attention(q[i], k[i], v[i], end[i], start[i], scale=hd ** -0.5)
    batch = run(slice(None))
    for i in range(b):
        assert torch.equal(run(slice(i, i + 1)), batch[i:i + 1]), f"lane {i}"


@pytest.mark.parametrize("nb", [256, 125, 37])
def test_split_is_batch_invariant(dev, gen, nb):
    """B2 at 4 splits: each lane of a batch of 4 with other fills gives the same
    partials and merged bits as the lane computed alone, at the same table width."""
    from repro_torch.kernels.decode_attention import decode_attention as da

    b, hkv, g, hd, bsz = 4, 2, 4, 128, 8
    span = nb * bsz
    end = torch.tensor([span, span // 3 + 5, 0, span - 7], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 3, 0, span // 2 + 1], dtype=torch.int32, device=dev)
    q, kp, vp, table = paged(gen, dev, b, hkv, g, hd, bsz, nb, torch.bfloat16)

    def run(i):
        parts = da.split_partials(q[i], kp, vp, table[i], end[i], start[i], num_splits=4,
                                  scale=hd ** -0.5)
        return [*parts, da.merge_splits(*parts)]
    batch = run(slice(None))
    for i in range(b):
        for alone, full in zip(run(slice(i, i + 1)), batch):
            assert torch.equal(alone, full[i:i + 1]), f"lane {i}"


def test_contiguous_decode_refuses_bad_operands(dev, gen):
    from repro_torch.kernels.decode_attention import decode_attention as da

    q, k, v = contiguous(gen, dev, 1, 1, 2, 32, 16, torch.float32)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v[:, :, :8], 4, scale=0.1)
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k.half(), v.half(), 4, scale=0.1)


def ssd_inputs(gen, dev, b, t, h, p, n, decay=1.0):
    x = torch.randn((b, t, h, p), generator=gen, device=dev) * 0.5
    a = -torch.randn((b, t, h), generator=gen, device=dev).abs() * (0.3 * decay)
    bm = torch.randn((b, t, n), generator=gen, device=dev) * 0.5
    cm = torch.randn((b, t, n), generator=gen, device=dev) * 0.5
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) * 0.1
    return x, a, bm, cm, s0


# f32 on both sides; the chunked form sums the same terms in another order and
# takes exp of cumulative log decays where the recurrence multiplies step decays
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t,h,p,n,q,decay", [
    (2, 64, 3, 16, 8, 16, 1.0), (1, 100, 2, 32, 16, 32, 1.0),     # 100 % 32: the pad path
    (2, 512, 4, 64, 64, 256, 1.0), (1, 24, 1, 64, 64, 8, 1.0),
    (1, 96, 2, 24, 12, 32, 1.0),        # P and N not multiples of 16
    (2, 80, 2, 64, 64, 8, 1.0),         # a chunk under the kernel's sub-chunk of 32
    (1, 96, 2, 64, 64, 24, 1.0),        # a chunk that is not a multiple of it
    (2, 1, 3, 64, 64, 256, 1.0),        # T = 1
    (1, 40, 2, 32, 16, 256, 1.0),       # T under the chunk
    (2, 512, 4, 64, 64, 256, 3.0),      # strong decays: three times the log decay
    (2, 64, 4, 16, 16, 8, 1.0),         # zamba2 smoke's widths (configs/zamba2_7b.py)
    (1, 64, 2, 100, 64, 64, 1.0),       # P over 64: two blocks of state rows a head
    (1, 50, 2, 7, 5, 25, 1.0),          # P, N not multiples of 4: 4-byte copies
    (2, 128, 3, 64, 128, 64, 1.0),      # N over 64: two column tiles
    (1, 50, 2, 7, 130, 25, 1.0),        # three column tiles, the last of 2, 4-byte copies
])
def test_ssd_scan_matches_plain(dev, gen, b, t, h, p, n, q, decay):
    """B5 against the sequential recurrence."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    ops = ssd_inputs(gen, dev, b, t, h, p, n, decay)
    before = ss.ssd_scan.launches
    y, s = ssd_scan_op(*ops, chunk=q)
    yr, sr = ssd_scan_ref(*ops)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    assert tuple(y.shape) == (b, t, h, p) and tuple(s.shape) == (b, h, p, n)
    torch.testing.assert_close(y, yr, **SSD_TOL)
    torch.testing.assert_close(s, sr, **SSD_TOL)


def test_ssd_scan_lane_alone_matches_the_batch(dev, gen):
    """A lane scanned alone gives the same bits as that lane inside a batch."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op

    ops = ssd_inputs(gen, dev, 3, 200, 4, 64, 64)
    y, s = ssd_scan_op(*ops, chunk=64)
    for i in range(3):
        yi, si = ssd_scan_op(*(o[i:i + 1] for o in ops), chunk=64)
        torch.cuda.synchronize()
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(si, s[i:i + 1]), f"lane {i}"


def test_ssd_scan_refuses_bad_operands(dev, gen):
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    x, a, bm, cm, s0 = ssd_inputs(gen, dev, 1, 48, 2, 16, 8)
    with pytest.raises(ValueError):
        ssd_scan(x, a, bm, cm, s0, chunk=32)          # 48 % 32 != 0: the op pads, not the kernel
    with pytest.raises(ValueError):
        ssd_scan(x, a, bm, cm, s0, chunk=0)
    with pytest.raises(TypeError):
        ssd_scan(x.double(), a, bm, cm, s0, chunk=16)
    with pytest.raises(ValueError):                   # s0 must carry every state column
        ssd_scan(x, a, bm, cm, s0[..., :4], chunk=16)


def test_contiguous_and_hybrid_serves_on_the_card_go_through_b4(dev):
    """llama3-8b smoke through a contiguous pool and zamba2-7b smoke: tokens
    identical across modes, the contiguous kernel launched, no paged kernel
    and no scan launched."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import init_params
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.serving_model import ServingModel

    reqs = [GenerationRequest(prompt=list(range(1, 2 + 3 * i)), max_new_tokens=4 + i)
            for i in range(5)]
    for name in ("llama3-8b", "zamba2-7b"):
        cfg = get_config(name, smoke=True).replace(quantized_decode=True)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        sm = ServingModel.prepare(cfg, params, max_len=64, slots=2)
        outs = {}
        reset_launches()
        for mode in (Mode.BLOCKED, Mode.HBCEM, Mode.LBIM):
            pool = sm.cache_pool(slots=2, prefix_cache=False, block_size=4, paged=False)
            eng = Engine(sm.cfg, sm.params, max_len=64, slots=2, mode=mode, chunk=4,
                         serving=sm, prefix_cache=False, pool=pool)
            outs[mode] = [r.tokens for r in eng.serve(reqs)]
            assert not eng.pool.paged and eng.pool.check_invariants() == []
        assert outs[Mode.HBCEM] == outs[Mode.BLOCKED] == outs[Mode.LBIM]
        counts = launch_counts()
        assert counts["decode_attention"] > 0 and counts["pim_gemv"] > 0
        assert counts["decode_attention_paged"] == counts["ssd_scan"] == 0


# --------------------------------------------------------------------------
# the engine on the card against the CPU path (plain versions)
# --------------------------------------------------------------------------

SERVE_PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [7, 7], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4],
                 [9], [5, 3, 5, 8, 9, 7, 9, 3]]
SERVE_BUDGETS = [9, 12, 6, 10, 8]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.fixture
def no_tf32():
    """f32 matmuls in full f32 on the card, as chip_smoke.py sets them."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def smoke_pair(dev, **overrides):
    """llama3-8b smoke params made once on the CPU (seeded) and copied to the
    card, with the config they were made for."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config("llama3-8b", smoke=True).replace(**overrides)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, _to(cpu, dev)


def serve_tokens(cfg, params, device, mode, samplers=None, spec_k=None):
    from repro_torch.serve.api import GenerationRequest, SamplingParams
    from repro_torch.serve.serving_model import ServingModel
    from repro_torch.serve.spec import SpecConfig

    sm = ServingModel.prepare(cfg, params, max_len=64, slots=2, device=device)
    spec = SpecConfig(draft=sm, k=spec_k) if spec_k else None
    eng = sm.engine(mode=mode, chunk=4, spec=spec)
    samplers = samplers or [{}] * len(SERVE_PROMPTS)
    res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b,
                                       sampling=SamplingParams(**s))
                     for p, b, s in zip(SERVE_PROMPTS, SERVE_BUDGETS, samplers)])
    assert eng.pool.check_invariants() == []
    if spec is not None:
        assert eng.spec_dec.pool.check_invariants() == []
    assert all(len(r.tokens) == b for r, b in zip(res, SERVE_BUDGETS))
    return [r.tokens for r in res], eng


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("mode", ["BLOCKED", "HBCEM", "LBIM"])
def test_engine_tokens_on_the_card_equal_the_cpu_path(dev, no_tf32, mode, splits):
    """f32 smoke through the paged pool, W8A8 off: the greedy tokens served on
    the card (B1 at one split, B2 stage 1 and the merge at four) equal those
    served on the CPU by the plain versions."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches

    cfg, cpu, cuda = smoke_pair(dev, dtype="float32", param_dtype="float32",
                                decode_kv_splits=splits)
    want, _ = serve_tokens(cfg, cpu, "cpu", Mode[mode])
    reset_launches()
    got, eng = serve_tokens(cfg, cuda, dev, Mode[mode])
    assert eng.pool.paged
    counts = launch_counts()
    if splits == 1:
        assert counts["decode_attention_paged"] > 0
    else:
        assert counts["decode_attention_paged_split"] == counts["merge_splits"] > 0
    assert got == want


def _random_paged_cache(cfg, b, nb, bsz, fills, seed, dtype):
    from repro_torch.core import kv_mapping

    g = torch.Generator().manual_seed(seed)
    pages = kv_mapping.init_paged_cache(cfg.n_layers, b * nb + 1, cfg.n_kv_heads,
                                        cfg.head_dim, bsz, dtype, "cpu")
    for k in pages:
        pages[k].copy_(torch.randn(pages[k].shape, generator=g) * 0.3)
    table = (torch.randperm(b * nb, generator=g) + 1).reshape(b, nb).to(torch.int32)
    return {**pages, "block_table": table, "pos": torch.tensor(fills, dtype=torch.int32)}


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("case", ["w8a8_f32", "bf16_hd64"])
def test_decode_logits_per_step_on_the_card(dev, no_tf32, case, splits):
    """One-token decode steps of a ragged paged batch, the card against the
    plain path on the CPU, each step restarted from the CPU's cache (a shared
    cache: under W8A8 an f32 ulp can flip one int8 rounding, and carried over
    steps that would compare two roundings, not two step functions).

    ``w8a8_f32``: f32 smoke with ``quantized_decode``, at the CPU W8A8 tests'
    tolerance (rtol = atol = 1e-4) and equal argmaxes. ``bf16_hd64``: bf16
    smoke with a head dim of 64, so B1 and B2 take their tensor-core branch;
    bf16 rounds activations at other places on the two sides (2**-8 relative
    a rounding, over two layers and the lm_head), so rtol = atol = 3e-2."""
    from repro_torch.models import model as TM
    from repro_torch.serve.serving_model import ServingModel

    if case == "w8a8_f32":
        over = dict(dtype="float32", param_dtype="float32", quantized_decode=True)
        tol, dtype = dict(rtol=1e-4, atol=1e-4), torch.float32
    else:
        over = dict(dtype="bfloat16", param_dtype="bfloat16", d_head=64)
        tol, dtype = dict(rtol=3e-2, atol=3e-2), torch.bfloat16
    cfg, cpu, cuda = smoke_pair(dev, decode_kv_splits=splits, **over)
    sm_cpu = ServingModel.prepare(cfg, cpu, max_len=64, slots=3, device="cpu")
    sm_dev = ServingModel.prepare(cfg, cuda, max_len=64, slots=3, device=dev)
    cache = _random_paged_cache(cfg, 3, 16, 4, [5, 0, 37], 11, dtype)
    r = np.random.default_rng(5)
    for _ in range(4):
        tokens = torch.from_numpy(r.integers(1, cfg.vocab_size, (3, 1))).long()
        dev_cache = _to(cache, dev)
        want, cache = TM.decode_step(sm_cpu.decode_params, cache, tokens, cfg)
        got, _ = TM.decode_step(sm_dev.decode_params, dev_cache, tokens.to(dev), cfg)
        torch.testing.assert_close(got.float().cpu(), want.float(), **tol)
        if case == "w8a8_f32":
            assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))


def test_sample_masked_on_the_card_equals_the_cpu(dev):
    """The port's threefry and filter on CUDA tensors: the same tokens as on
    the CPU for the same logits and keys (llama3-8b's vocab)."""
    from repro_torch.serve import sampling

    g = torch.Generator().manual_seed(2)
    lg = torch.randn((4, 1, 128256), generator=g) * 3
    keys = torch.stack([sampling.token_key(sampling.request_key(s, [1, 2, s]), s)
                        for s in range(4)])
    args = dict(temperature=torch.tensor([0.8, 0.0, 1.2, 0.7]),
                top_k=torch.tensor([50, 0, 0, 5]), top_p=torch.tensor([0.95, 1.0, 0.5, 1.0]))
    done = torch.tensor([False, False, False, True])
    want = sampling.sample_masked(lg, done, keys=keys, **args)
    got = sampling.sample_masked(lg.to(dev), done.to(dev), keys=keys.to(dev),
                                 **{k: v.to(dev) for k, v in args.items()})
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", ["HBCEM", "LBIM"])
def test_spec_serve_on_the_card(dev, no_tf32, mode):
    """Self-draft speculation on the card (f32 smoke, W8A8): tokens equal the
    non-spec serve's, greedy and sampled; the draft rolls out through B4 on
    batch-1 contiguous lanes and verify runs B1 over the forked rows."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches

    cfg, _, cuda = smoke_pair(dev, dtype="float32", param_dtype="float32",
                              quantized_decode=True)
    samplers = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1), {}, {},
                dict(temperature=0.8, top_k=50, top_p=0.95, seed=2), {}]
    plain, _ = serve_tokens(cfg, cuda, dev, Mode[mode], samplers)
    reset_launches()
    spec, eng = serve_tokens(cfg, cuda, dev, Mode[mode], samplers, spec_k=3)
    assert spec == plain
    rep = eng.schedule_report()["spec"]
    assert rep["rounds"] > 0 and rep["accepted"] > 0
    counts = launch_counts()
    assert counts["decode_attention"] > 0 and counts["decode_attention_paged"] > 0


def _traffic_serve(cfg, params, device, reqs, *, plan=None, spec_k=None):
    """One HBCEM serve of ``reqs`` (slots 2, chunk 4) with an optional fault
    plan and self-draft; the pool (and the draft pool) audited clean."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.serve.serving_model import ServingModel
    from repro_torch.serve.spec import SpecConfig

    sm = ServingModel.prepare(cfg, params, max_len=64, slots=2, device=device)
    eng = sm.engine(mode=Mode.HBCEM, chunk=4,
                    spec=SpecConfig(draft=sm, k=spec_k) if spec_k else None)
    eng.fault_plan = plan
    res = eng.serve(reqs)
    assert eng.pool.check_invariants() == []
    assert eng.pool.occupancy().slots_used == 0
    if spec_k:
        assert eng.spec_dec.pool.check_invariants() == []
    return res, eng


# the reference suite's preemption scenario: request 2 outranks two running lanes
PREEMPT_PROMPTS = [[1, 2, 3], [1, 2, 3, 4, 5, 6, 7], [5, 5]]
PREEMPT_BUDGETS = [6, 6, 4]


def _serve_requests(over=None, prompts=SERVE_PROMPTS, budgets=SERVE_BUDGETS):
    """Requests of ``prompts``/``budgets``; ``over`` maps an index to fields."""
    import dataclasses

    from repro_torch.serve.api import GenerationRequest

    reqs = [GenerationRequest(prompt=p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    for i, kw in (over or {}).items():
        reqs[i] = dataclasses.replace(reqs[i], **kw)
    return reqs


@pytest.mark.parametrize("op", ["decode_attention", "pim_gemv"])
def test_injected_kernel_fault_on_the_card_fails_only_its_participants(dev, no_tf32, op):
    """On the card a kernel is live, so ``kernel_exc`` fires (at the top of
    an attempt, before any launch). The one-rung ladder cannot recover: that
    step's participants fail with a typed error, every other request finishes
    with the f32 smoke tokens the CPU path serves without faults, and the
    health counters show one kernel fault, one failure and no fallback."""
    from repro_torch.serve.api import RequestState
    from repro_torch.serve.faults import Fault, FaultPlan

    cfg, cpu, cuda = smoke_pair(dev, dtype="float32", param_dtype="float32")
    want, _ = _traffic_serve(cfg, cpu, "cpu", _serve_requests())
    plan = FaultPlan(faults=[Fault("kernel_exc", 4, op=op)])
    got, eng = _traffic_serve(cfg, cuda, dev, _serve_requests(), plan=plan)
    assert plan.fired() == 1
    failed = [i for i, r in enumerate(got) if r.state is RequestState.FAILED]
    [ev] = [e for e in eng.events if e.failed]    # the one failed step
    assert len(failed) == ev.decode_batch + (1 if ev.prefill_tokens else 0) >= 1
    assert {got[i].finish_step for i in failed} == {ev.clock + 1 + ev.slow_penalty}
    for i, (r, w) in enumerate(zip(got, want)):
        if i in failed:
            assert "ladder exhausted" in r.error and r.tokens == w.tokens[:len(r.tokens)]
        else:
            assert r.state is RequestState.FINISHED and r.tokens == w.tokens
    h = eng.health()
    assert h["ladder"][op]["kernel_faults"] == 1 and h["ladder"][op]["backend"] == "kernel"
    assert all(c["fallbacks"] == 0 for c in h["ladder"].values()) and not h["degraded"]
    assert h["counters"]["failures"] == 1 and h["counters"]["injected_faults"] == 1


@pytest.mark.parametrize("spec_k", [None, 2])
def test_priority_preemption_resume_on_the_card_equals_the_cpu(dev, no_tf32, spec_k):
    """A high-priority request preempts a running (with ``spec_k``, a
    speculating) lane; the victim resumes by re-prefilling prompt + emitted
    tokens. The f32 smoke tokens, states and preemption counts on the card
    equal the CPU path's."""
    cfg, cpu, cuda = smoke_pair(dev, dtype="float32", param_dtype="float32")
    reqs = lambda: _serve_requests({2: dict(priority=5)}, PREEMPT_PROMPTS,  # noqa: E731
                                   PREEMPT_BUDGETS)
    want, _ = _traffic_serve(cfg, cpu, "cpu", reqs(), spec_k=spec_k)
    got, eng = _traffic_serve(cfg, cuda, dev, reqs(), spec_k=spec_k)
    assert sum(r.preemptions for r in got) >= 1
    assert [(r.tokens, r.state, r.preemptions) for r in got] == \
        [(r.tokens, r.state, r.preemptions) for r in want]
    assert eng.health()["counters"]["failures"] == 0


def test_window_starts_and_softcap_on_the_tensor_cores(dev, gen):
    """gemma2-27b's attention shape (G 2, hd 128, bf16: the tensor-core
    branch) with softcap 50, scale 144^-0.5 and every lane starting past 0,
    as its local layers' windows give: B1 over 8-token pages (and B2 at 4
    splits), B4 over contiguous lanes; ranges inside one chunk, across chunk
    boundaries and one empty."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv, g, hd, nb, cap, scale = 4, 2, 2, 128, 80, 50.0, 144.0 ** -0.5
    end = torch.tensor([640, 300, 17, 250], dtype=torch.int32, device=dev)
    start = torch.tensor([120, 44, 17, 1], dtype=torch.int32, device=dev)
    q, kp, vp, table = paged(gen, dev, b, hkv, g, hd, 8, nb, torch.bfloat16)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, cap, start=start)
    torch.testing.assert_close(da.decode_attention_paged(q, kp, vp, table, end, start,
                                                         scale=scale, softcap=cap), want, **TOL)
    torch.testing.assert_close(da.decode_attention_paged_split(
        q, kp, vp, table, end, start, num_splits=4, scale=scale, softcap=cap), want, **TOL)
    q, k, v = contiguous(gen, dev, b, hkv, g, hd, nb * 8, torch.bfloat16)
    out = da.decode_attention(q, k, v, end, start, scale=scale, softcap=cap)
    torch.testing.assert_close(out, ref.decode_attention_ref(q, k, v, end, scale, cap,
                                                             start=start), **TOL)
    assert not out[2].any()


def gemma2_pair(dev, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config("gemma2-27b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32", **overrides)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, _to(cpu, dev)


@pytest.mark.parametrize("ring", [False, True], ids=["paged", "ring"])
@pytest.mark.parametrize("mode", ["BLOCKED", "HBCEM", "LBIM"])
def test_gemma2_tokens_on_the_card_equal_the_cpu_path(dev, no_tf32, mode, ring):
    """f32 gemma2 smoke (window 8, softcaps, tied embeddings) on the paged
    pool (B1 with window starts) and on the ring pool (B4 over 8-slot rings
    and full lanes, solo-prefill admission): the greedy tokens served on the
    card equal those served on the CPU."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches

    cfg, cpu, cuda = gemma2_pair(dev, windowed_kv_cache=ring)
    want, _ = serve_tokens(cfg, cpu, "cpu", Mode[mode])
    reset_launches()
    got, eng = serve_tokens(cfg, cuda, dev, Mode[mode])
    assert eng.pool.paged != ring
    counts = launch_counts()
    assert counts["decode_attention" if ring else "decode_attention_paged"] > 0
    assert got == want


# --------------------------------------------------------------------------
# the MoE family (olmoe-1b-7b, phi3.5-moe)
# --------------------------------------------------------------------------

# (N, K) of the W8A8 projections at full width: olmoe's wq/wk/wv/wo; phi3.5's
# wq/wo and its wk/wv (8 KV heads of 128)
MOE_GEMV = [(2048, 2048), (4096, 4096), (1024, 4096)]


@pytest.mark.parametrize("n,k", MOE_GEMV)
def test_pim_gemv_bit_exact_at_moe_shapes(dev, gen, n, k):
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv
    from repro_torch.kernels.pim_gemv.ref import pim_gemv_ref

    ops = gemv_operands(n, k, 4, gen, dev)
    assert torch.equal(pim_gemv(*ops), pim_gemv_ref(*ops))


@pytest.mark.parametrize("hkv,g,nb", [(16, 1, 50), (8, 4, 50)])   # olmoe; phi3.5
def test_paged_decode_at_moe_shapes(dev, gen, hkv, g, nb):
    """B1 and the B2 pair (4 splits) at the MoE serves' head layouts, hd 128,
    bf16 pages of 8 tokens."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    q, kp, vp, table = paged(gen, dev, 4, hkv, g, 128, 8, nb, torch.bfloat16)
    end, start = live_ranges(nb * 8, False, dev)
    start = torch.zeros_like(start)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, 128 ** -0.5, None,
                                          start=start)
    out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=128 ** -0.5)
    torch.testing.assert_close(out, want, **TOL)
    pair = da.decode_attention_paged_split(q, kp, vp, table, end, start, num_splits=4,
                                           scale=128 ** -0.5)
    torch.testing.assert_close(pair, want, **TOL)


MOE_PROMPTS = [[5] * 17, [3, 1, 4], [2, 7, 1, 8], [9, 9, 8, 2, 6, 5], [7] * 17,
               [4, 4, 2, 1, 3, 5, 8, 9, 7]]
MOE_BUDGETS = [5, 7, 3, 6, 4, 8]


@pytest.mark.parametrize("mode", ["BLOCKED", "HBCEM", "LBIM"])
def test_moe_tokens_on_the_card_equal_the_cpu_path(dev, no_tf32, mode):
    """f32 olmoe smoke on the paged pool with four lanes, W8A8 off: picks drop
    in decode steps (capacity 2 of 4 lanes, free lanes included, whose writes
    collide in the dummy page), in chunks and in the padded batch admission;
    the greedy tokens served on the card (B1) equal those served on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import init_params
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.serving_model import ServingModel

    cfg = get_config("olmoe-1b-7b", smoke=True).replace(dtype="float32",
                                                         param_dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def serve(params, device):
        eng = ServingModel.prepare(cfg, params, max_len=32, slots=4, device=device).engine(
            mode=Mode[mode], chunk=4)
        res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                         for p, b in zip(MOE_PROMPTS, MOE_BUDGETS)])
        assert eng.pool.check_invariants() == []
        assert [len(r.tokens) for r in res] == MOE_BUDGETS
        return [r.tokens for r in res]

    want = serve(cpu, "cpu")
    reset_launches()
    got = serve(_to(cpu, dev), dev)
    assert launch_counts()["decode_attention_paged"] > 0
    assert got == want


# --------------------------------------------------------------------------
# the last serving families: rwkv6, internvl2 (vlm), seamless (audio)
# --------------------------------------------------------------------------


def family_pair(arch, **overrides):
    """An f32 smoke config of ``arch`` and its seeded CPU params."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32",
                                               **overrides)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("arch,quantized", [("rwkv6-1.6b", False), ("internvl2-2b", False),
                                            ("internvl2-2b", True)])
@pytest.mark.parametrize("mode", ["BLOCKED", "HBCEM", "LBIM"])
def test_family_tokens_on_the_card_equal_the_cpu_path(dev, no_tf32, arch, quantized, mode):
    """f32 smoke serves, the card against the CPU: rwkv6 on its recurrent-state
    pool launches no kernel of the port (attention-free, plain matmuls);
    internvl2-2b on the paged pool runs B1 (and, W8A8, B3)."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.serving_model import ServingModel

    cfg, cpu = family_pair(arch, quantized_decode=quantized)

    def serve(params, device):
        eng = ServingModel.prepare(cfg, params, max_len=64, slots=2, device=device).engine(
            mode=Mode[mode], chunk=4)
        res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                         for p, b in zip(SERVE_PROMPTS, SERVE_BUDGETS)])
        assert eng.pool.check_invariants() == []
        assert [len(r.tokens) for r in res] == SERVE_BUDGETS
        return [r.tokens for r in res], eng

    want, _ = serve(cpu, "cpu")
    reset_launches()
    got, eng = serve(_to(cpu, dev), dev)
    counts = launch_counts()
    if cfg.family == "ssm":
        assert not eng.pool.paged and not any(counts.values())
    else:
        assert eng.pool.paged and counts["decode_attention_paged"] > 0
        assert (counts["pim_gemv"] > 0) == quantized
    assert got == want


@pytest.mark.parametrize("quantized", [False, True])
def test_audio_decode_logits_per_step_on_the_card(dev, no_tf32, quantized):
    """f32 seamless smoke at model level: the encoder prefill over stub frames,
    then greedy decode steps (B4 over the self-KV lanes, B3 under W8A8), the
    card against the CPU, each step restarted from the CPU's cache."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as TM
    from repro_torch.serve.serving_model import ServingModel

    cfg, cpu = family_pair("seamless-m4t-large-v2", quantized_decode=quantized)
    sm_cpu = ServingModel.prepare(cfg, cpu, max_len=24, slots=3, device="cpu")
    sm_dev = ServingModel.prepare(cfg, _to(cpu, dev), max_len=24, slots=3, device=dev)
    frames = torch.randn((3, 37, cfg.d_model), generator=torch.Generator().manual_seed(4))
    bos = torch.ones((3, 1), dtype=torch.long)
    want, cache = TM.prefill(sm_cpu.params, bos, cfg, 24, src_frames=frames)
    got, _ = TM.prefill(sm_dev.params, bos.to(dev), cfg, 24, src_frames=frames.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    tok = want.argmax(-1)
    reset_launches()
    for step in range(5):
        dev_cache = _to(cache, dev)
        want, cache = TM.decode_step(sm_cpu.decode_params, cache, tok, cfg)
        got, _ = TM.decode_step(sm_dev.decode_params, dev_cache, tok.to(dev), cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
        tok = want.argmax(-1)
    counts = launch_counts()
    assert counts["decode_attention"] == 5 * cfg.n_layers
    assert counts["pim_gemv"] == (5 * 7 * cfg.n_layers if quantized else 0)


@pytest.mark.parametrize("mode", ["HBCEM", "LBIM"])
def test_rwkv6_draft_for_llama_target_on_the_card(dev, no_tf32, mode):
    """The cross-family draft on the card (f32 smoke, vocab 256 both): spec
    tokens equal the plain serve's and the CPU path's; the target verifies
    through B1, the rwkv6 draft launches nothing."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.serving_model import ServingModel
    from repro_torch.serve.spec import SpecConfig

    tcfg, tcpu, _ = smoke_pair(dev, dtype="float32", param_dtype="float32")
    dcfg, dcpu = family_pair("rwkv6-1.6b")

    def serve(device, spec):
        target = ServingModel.prepare(tcfg, _to(tcpu, device), max_len=64, slots=2,
                                      device=device)
        draft = ServingModel.prepare(dcfg, _to(dcpu, device), max_len=64, slots=2,
                                     device=device)
        eng = target.engine(mode=Mode[mode], chunk=4,
                            spec=SpecConfig(draft=draft, k=3) if spec else None)
        res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                         for p, b in zip(SERVE_PROMPTS, SERVE_BUDGETS)])
        assert eng.pool.check_invariants() == []
        return [r.tokens for r in res], eng

    want, _ = serve("cpu", True)
    plain, _ = serve(dev, False)
    reset_launches()
    got, eng = serve(dev, True)
    rep = eng.schedule_report()["spec"]
    assert rep["rounds"] > 0 and rep["draft_steps"] > 0
    counts = launch_counts()
    assert counts["decode_attention_paged"] > 0 and counts["decode_attention"] == 0
    assert got == plain == want


@pytest.mark.parametrize("lmax,fills", [(40, [2, 17, 33, 40]), (336, [281, 300, 336, 1]),
                                        (512, [0, 257, 512, 100])])
def test_contiguous_decode_at_g1_hd64(dev, gen, lmax, fills):
    """B4 at seamless-m4t-large-v2's decoder shape (16 KV heads of 64, one
    query head each: the bf16 tensor-core branch at its narrowest head) over
    its self-KV lanes and longer ones, against the plain version, each lane
    alone too."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    q, k, v = contiguous(gen, dev, 4, 16, 1, 64, lmax, torch.bfloat16)
    end = torch.tensor(fills, dtype=torch.int32, device=dev)
    start = torch.zeros_like(end)
    out = da.decode_attention(q, k, v, end, start, scale=0.125)
    want = ref.decode_attention_ref(q, k, v, end, 0.125, start=start)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL)
    for i in range(4):
        alone = da.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], end[i:i + 1],
                                    start[i:i + 1], scale=0.125)
        assert torch.equal(alone, out[i:i + 1])


# --------------------------------------------------------------------------
# B3's K splits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,b", [(1024, 4096, 4), (1024, 1024, 1), (2048, 8192, 8),
                                   (4096, 14336, 4), (512, 4096, 17)])
def test_pim_gemv_split_k_sums_every_split(dev, gen, n, k, b):
    """Narrow N takes K splits (a cluster per row tile whose blocks sum their
    int32 partials through distributed shared memory): all splits hold K
    tiles and the sum is exact."""
    from repro_torch.kernels.pim_gemv.pim_gemv import plan

    p = plan(n, k, b)
    k_tiles = -(-k // 128)
    assert p["tensor_cores"] and 1 < p["splits"] <= 8
    assert (p["splits"] - 1) * p["k_tiles_per_split"] < k_tiles <= p["splits"] * p[
        "k_tiles_per_split"]
    _gemv_exact(n, k, b, gen, dev)


# --------------------------------------------------------------------------
# fp8 e4m3 K/V: B1, the B2 pair and B4, the pool's ops, the engine
# --------------------------------------------------------------------------

F8 = torch.float8_e4m3fn


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nb,edges", [(256, False), (37, False), (100, True)])
def test_fp8_paged_decode_and_split_match_plain(dev, gen, qdtype, nb, edges):
    """B1 and the B2 pair (4 splits) over fp8 pages at llama3-8b's G 4 / hd 128:
    a lane of 8 chunks (nb 256), an empty lane, dead splits, start > 0, each
    lane alone too. Both sides widen e4m3 to f32 exactly and accumulate in f32
    in other orders: the f32 tolerance."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv, g, hd, bsz = 4, 8, 4, 128, 8
    q, kp, vp, table = paged(gen, dev, b, hkv, g, hd, bsz, nb, torch.float32)
    q, kp, vp = q.to(qdtype), kp.to(F8), vp.to(F8)
    end, start = live_ranges(nb * bsz, edges, dev)
    scale = hd ** -0.5
    before = (da.decode_attention_paged.launches, da.split_partials.launches,
              da.merge_splits.launches)
    out = da.decode_attention_paged(q, kp, vp, table, end, start, scale=scale)
    acc, m, l = da.split_partials(q, kp, vp, table, end, start, num_splits=4, scale=scale)
    merged = da.merge_splits(acc, m, l)
    torch.cuda.synchronize()
    assert (da.decode_attention_paged.launches, da.split_partials.launches,
            da.merge_splits.launches) == tuple(c + 1 for c in before)
    want = ref.decode_attention_paged_ref(q, kp, vp, table, end, scale, start=start)
    torch.testing.assert_close(out, want, **TOL)
    racc, rm, rl = ref.split_partials_ref(q, kp, vp, table, end, 4, scale, start=start)
    for a, r in ((acc, racc), (m, rm), (l, rl)):
        torch.testing.assert_close(a, r, **TOL)
    dead = rl == 0
    assert dead.any() and bool((m[dead] == ref.NEG_INF).all()) and not acc[dead].any()
    torch.testing.assert_close(merged, want, **TOL)
    assert not out[2].any() and not merged[2].any()
    for i in range(b):
        alone = da.decode_attention_paged(q[i:i + 1], kp, vp, table[i:i + 1], end[i:i + 1],
                                          start[i:i + 1], scale=scale)
        assert torch.equal(alone, out[i:i + 1]), f"lane {i}"
        parts = da.split_partials(q[i:i + 1], kp, vp, table[i:i + 1], end[i:i + 1],
                                  start[i:i + 1], num_splits=4, scale=scale)
        assert torch.equal(da.merge_splits(*parts), merged[i:i + 1]), f"lane {i}"


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,hd,lmax", [(4, 128, 2048), (4, 128, 296), (1, 112, 600)])
def test_fp8_contiguous_decode_matches_plain(dev, gen, qdtype, g, hd, lmax):
    """B4 over fp8 lanes: llama3-8b's shape (8 chunks; the contiguous serve's
    Lmax 296) and zamba2-7b's G 1 / hd 112, an empty lane and start > 0, each
    lane alone too."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ref

    b, hkv = 4, 4
    q, k, v = contiguous(gen, dev, b, hkv, g, hd, lmax, torch.float32)
    q, k, v = q.to(qdtype), k.to(F8), v.to(F8)
    end, start = live_ranges(lmax, False, dev)
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, end, start, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(out, ref.decode_attention_ref(q, k, v, end, hd ** -0.5,
                                                             start=start), **TOL)
    assert not out[2].any()
    for i in range(b):
        alone = da.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], end[i:i + 1],
                                    start[i:i + 1], scale=hd ** -0.5)
        assert torch.equal(alone, out[i:i + 1]), f"lane {i}"


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype == F8
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


def test_fp8_pool_ops_on_the_card_move_the_cpu_bits(dev):
    """Every op an fp8 decode step runs on the pool, on the card and on the
    CPU from the same inputs: the page scatter (one token, with free lanes
    colliding on the dummy page, and a chunk), the contiguous append, the
    gather of lanes from pages, a copy-on-write page copy, the staging
    stream's pagify into fresh pages, and a contiguous lane's copy and
    zeroing: the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.core import kv_mapping as kv
    from repro_torch.serve import cache as C

    g = torch.Generator().manual_seed(7)
    b, h, hd, bsz, nb = 4, 2, 16, 4, 5
    kp = (torch.randn((b * nb + 1, h, hd, bsz), generator=g) * 0.5).to(F8)
    vp = (torch.randn((b * nb + 1, h, bsz, hd), generator=g) * 0.5).to(F8)
    table = (torch.randperm(b * nb, generator=g) + 1).reshape(b, nb).to(torch.int32)
    table[2:] = 0                                     # two free lanes on the dummy page
    for t, pos in ((1, [3, 9, 0, 0]), (3, [0, 5, 2, 7])):
        kn = torch.randn((b, h, t, hd), generator=g)
        vn = torch.randn((b, h, t, hd), generator=g)
        tab = table if t == 1 else (torch.randperm(b * nb, generator=g) + 1).reshape(
            b, nb).to(torch.int32)
        pos = torch.tensor(pos, dtype=torch.int32)
        sides = [[x.clone() for x in (kp, vp)], [x.to(dev) for x in (kp, vp)]]
        for (k_, v_), d in zip(sides, ("cpu", dev)):
            kv.append_layer_paged(k_, v_, kn.to(d), vn.to(d), pos.to(d), tab.to(d), bsz)
        for want, got in zip(sides[0], sides[1]):
            _same_bits(got, want)
        for want, got in zip(kv.materialize_lanes(*sides[0], tab),
                             kv.materialize_lanes(*sides[1], tab.to(dev))):
            _same_bits(got, want)
    lanes = [(torch.randn((b, h, hd, 32), generator=g) * 0.5).to(F8),
             (torch.randn((b, h, 32, hd), generator=g) * 0.5).to(F8)]
    kn, vn = torch.randn((b, h, 2, hd), generator=g), torch.randn((b, h, 2, hd), generator=g)
    pos = torch.tensor([0, 5, 30, 31], dtype=torch.int32)
    sides = [[x.clone() for x in lanes], [x.to(dev) for x in lanes]]
    for (k_, v_), d in zip(sides, ("cpu", dev)):
        kv.append_layer(k_, v_, kn.to(d), vn.to(d), pos.to(d))
    for want, got in zip(*sides):
        _same_bits(got, want)

    # the pool's own page and lane surgery (a smoke config's shapes, fp8 pages)
    cfg = get_config("llama3-8b", smoke=True).replace(kv_dtype="float8_e4m3fn")
    src = {"k": (torch.randn((cfg.n_layers, 2, cfg.n_kv_heads, cfg.head_dim, 30),
                             generator=g) * 0.5).to(F8),
           "v": (torch.randn((cfg.n_layers, 2, cfg.n_kv_heads, 30, cfg.head_dim),
                             generator=g) * 0.5).to(F8)}
    states = []
    for d in ("cpu", dev):
        st = C.PagedKVState(cfg, 2, 32, 8, store_pages=4, prefix_cache=False, dtype=F8,
                            device=torch.device(d))
        st.pagify(0, {k: x.to(d) for k, x in src.items()}, 1, 27)   # 4 fresh pages
        st.pagify(1, {k: x.to(d) for k, x in src.items()}, 0, 13)
        row = st.fork_row(0)
        st.ensure_residency(0, 27)              # the shared write block: copy on write
        assert st.block_tables[0, 3] != row[3]
        st.drop_fork_row(row)
        states.append(st)
    assert (states[0].block_tables == states[1].block_tables).all()
    for key in ("k_pages", "v_pages"):
        _same_bits(states[1].pages[key], states[0].pages[key])
    leaves = [[x.clone() for x in src.values()], [x.to(dev) for x in src.values()]]
    for ls in leaves:
        for leaf in ls:
            C._copy_lane(leaf, leaf.clone(), 0, 1)
            C._zero_lane(leaf, 1)
    for want, got in zip(*leaves):
        _same_bits(got, want)


@pytest.mark.parametrize("paged,splits,mode", [
    (True, 1, "BLOCKED"), (True, 1, "HBCEM"), (True, 1, "LBIM"), (True, 4, "HBCEM"),
    (False, 1, "LBIM")])
def test_fp8_engine_tokens_on_the_card_equal_the_cpu_path(dev, no_tf32, paged, splits, mode):
    """f32 smoke with an fp8 KV cache: the greedy tokens served on the card
    (B1, the B2 pair at four splits, B4 over the contiguous pool, all on fp8
    K/V) equal those served on the CPU by the plain versions."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.api import GenerationRequest
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.serving_model import ServingModel

    cfg, cpu, cuda = smoke_pair(dev, dtype="float32", param_dtype="float32",
                                kv_dtype="float8_e4m3fn", decode_kv_splits=splits)

    def serve(params, device):
        sm = ServingModel.prepare(cfg, params, max_len=64, slots=2, device=device)
        pool = sm.cache_pool(paged=paged, block_size=4)
        assert pool.views()["k_pages" if paged else "k"].dtype == F8
        eng = Engine(sm.cfg, sm.params, max_len=64, slots=2, mode=Mode[mode], chunk=4,
                     serving=sm, pool=pool)
        res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                         for p, b in zip(SERVE_PROMPTS, SERVE_BUDGETS)])
        assert eng.pool.check_invariants() == []
        return [r.tokens for r in res]

    want = serve(cpu, "cpu")
    reset_launches()
    got = serve(cuda, dev)
    counts = launch_counts()
    name = ("decode_attention" if not paged else "decode_attention_paged" if splits == 1
            else "decode_attention_paged_split")
    assert counts[name] > 0
    assert got == want


# --- training (the full-sequence forward, autograd, AdamW) ------------------


def _train_batch(cfg, dev, b=2, s=16, seed=1) -> dict:
    """``test_torch_forward.py``'s batch shapes from a numpy seed."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = (0.02 * r.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        batch["src_frames"] = (0.02 * r.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _train_archs():
    from repro_torch.configs import list_archs

    return list_archs()


@pytest.mark.parametrize("arch", _train_archs())
def test_train_step_on_the_card_equals_the_cpu(dev, no_tf32, arch):
    """f32 smoke, the same seeded weights and batch on both sides: the loss
    within rtol 1e-4, every gradient leaf within rtol 1e-4 and an atol of
    1e-5 of its max |g|; then one AdamW step over the card's gradients
    against the CPU's step over the same gradients."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state, tree_leaves
    from repro_torch.train.train_step import value_and_grad

    cfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cuda = _to(cpu, dev)
    reset_launches()
    loss_d, grads_d = value_and_grad(cuda, _train_batch(cfg, dev), cfg)
    assert all(n == 0 for n in launch_counts().values())   # no kernel on this path
    loss_c, grads_c = value_and_grad(cpu, _train_batch(cfg, "cpu"), cfg)
    np.testing.assert_allclose(float(loss_d), float(loss_c), rtol=1e-4)
    for gd, gc in zip(tree_leaves(grads_d), tree_leaves(grads_c)):
        atol = 1e-5 * float(gc.abs().max()) if gc.numel() else 0.0
        np.testing.assert_allclose(gd.cpu().numpy(), gc.numpy(), rtol=1e-4, atol=atol)
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    new_d, _, stats_d = adamw_update(cuda, grads_d, init_opt_state(cuda), opt)
    new_c, _, stats_c = adamw_update(cpu, _to(grads_d, "cpu"), init_opt_state(cpu), opt)
    np.testing.assert_allclose(float(stats_d["grad_norm"]), float(stats_c["grad_norm"]),
                               rtol=1e-5)
    for pd, pc in zip(tree_leaves(new_d), tree_leaves(new_c)):
        np.testing.assert_allclose(pd.cpu().numpy(), pc.numpy(), rtol=1e-5, atol=1e-7)


def test_bf16_remat_train_step_on_the_card(dev):
    """One train step of the llama3-8b smoke config in its own bf16, each
    layer rematerialised: a finite loss and grad norm, params still bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.train.train_step import train_step

    cfg = get_config("llama3-8b", smoke=True).replace(remat=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    new, state, m = train_step(params, init_opt_state(params), _train_batch(cfg, dev, 4, 64),
                               cfg, AdamWConfig(), 1)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert {t.dtype for t in tree_leaves(new)} == {torch.bfloat16} and int(state.step) == 1


# --------------------------------------------------------------------------
# the launch tooling's count and the W8A8 linear on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_w8a8_linear_on_the_card_is_its_plain_version(dev, gen, lead):
    from repro_torch.core import quant
    from repro_torch.kernels.pim_gemv.pim_gemv import pim_gemv

    w = torch.randn((4096, 1024), generator=gen, device=dev) * 0.02
    x = torch.randn((*lead, 4096), generator=gen, device=dev)
    ql = quant.quantize_weight(w)
    before = pim_gemv.launches
    y = quant.w8a8_linear(ql, x)
    assert pim_gemv.launches == before + 1
    assert torch.equal(y, quant.w8a8_linear(ql, x, use_kernel=False))
    assert quant.quant_error(w, x, device=dev) < 0.02


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "decode_32k"), ("zamba2-7b", "decode_32k"),
                                        ("olmoe-1b-7b", "prefill_32k")])
def test_a_cell_counts_the_same_on_the_card_and_on_meta(dev, monkeypatch, arch, shape):
    """A smoke cell (B 2; decode over 64 slots, prefill of 16 tokens), W8A8
    decode: the card's count, kernels launched, equals the meta count."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import costrun

    spec = costrun.SHAPES[shape]
    monkeypatch.setitem(costrun.SHAPES, shape, dataclasses.replace(
        spec, global_batch=2, seq_len=64 if spec.kind == "decode" else 16))
    cfg = get_config(arch, smoke=True).replace(quantized_decode=True)
    assert costrun.count(costrun.build_cell(cfg, shape, device=dev)) == \
        costrun.count(costrun.build_cell(cfg, shape))


# --------------------------------------------------------------------------
# captured step programs (core.interleave) against eager ones
# --------------------------------------------------------------------------

# (arch, overrides, pool): every served family and pool kind at f32 smoke
GRAPH_SERVES = [
    ("llama3-8b", {}, "paged"), ("llama3-8b", {"quantized_decode": True}, "paged"),
    ("llama3-8b", {"quantized_decode": True}, "contiguous"),
    ("gemma2-27b", {}, "paged"), ("gemma2-27b", {"windowed_kv_cache": True}, "ring"),
    ("internvl2-2b", {"quantized_decode": True}, "paged"),
    ("olmoe-1b-7b", {"quantized_decode": True}, "paged"),
    ("phi3.5-moe-42b-a6.6b", {"quantized_decode": True}, "paged"),
    ("zamba2-7b", {"quantized_decode": True}, "contiguous"),
    ("rwkv6-1.6b", {}, "contiguous"),
]


def _graph_ab(cfg, params, dev, mode, reqs, *, pool_kind="paged", spec_k=None):
    """The same serve captured and then under ``interleave.eager()``, each on
    an engine of its own: (captured, eager), each (tokens, events' plans,
    launch counts, the engine's graph stats)."""
    from repro_torch.core import interleave
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.serving_model import ServingModel
    from repro_torch.serve.spec import SpecConfig

    sm = ServingModel.prepare(cfg, params, max_len=64, slots=2, device=dev)

    def serve():
        spec = SpecConfig(draft=sm, k=spec_k) if spec_k else None
        if pool_kind == "paged":
            eng = sm.engine(mode=Mode[mode], chunk=4, spec=spec)
        else:
            pool = sm.cache_pool(slots=2, prefix_cache=False, block_size=4, paged=False)
            eng = Engine(sm.cfg, sm.params, max_len=64, slots=2, mode=Mode[mode], chunk=4,
                         serving=sm, prefix_cache=False, pool=pool, spec=spec)
        reset_launches()
        res = eng.serve(reqs())
        torch.cuda.synchronize()
        assert eng.pool.check_invariants() == []
        return ([(r.state, r.tokens) for r in res], [e.plan for e in eng.events],
                launch_counts(), eng.graphs.stats())

    captured = serve()
    with interleave.eager():
        eager = serve()
    return captured, eager


def _assert_captured_equals_eager(captured, eager):
    assert captured[0] == eager[0]          # states and tokens
    assert captured[1] == eager[1]          # every step's plan
    assert captured[2] == eager[2]          # every kernel's launches
    st, est = captured[3], eager[3]
    # captured: only each key's first call ran eagerly, every other step replayed
    assert st["replays"] > 0 and st["eager_steps"] == st["keys"]
    assert st["captures"] == st["graphs"] > 0
    assert est["captures"] == est["replays"] == 0 and est["eager_steps"] > 0


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("mode", ["BLOCKED", "HBCEM", "LBIM"])
@pytest.mark.parametrize("arch,overrides,pool", GRAPH_SERVES,
                         ids=[f"{a}-{p}{'-w8a8' if o.get('quantized_decode') else ''}"
                              for a, o, p in GRAPH_SERVES])
def test_captured_serve_equals_eager(dev, no_tf32, arch, overrides, pool, mode, splits):
    """Every served family in every mode, at splits 1 and 2 on the paged
    pools: the captured serve's tokens, plans and launch counts equal the
    eager serve's, and after each key's first call every step replays."""
    if splits > 1 and pool != "paged":
        pytest.skip("KV splits apply to the paged pool only")
    cfg, cpu = family_pair(arch, decode_kv_splits=splits, **overrides)
    captured, eager = _graph_ab(cfg, _to(cpu, dev), dev, mode,
                                lambda: _serve_requests(), pool_kind=pool)
    _assert_captured_equals_eager(captured, eager)


@pytest.mark.parametrize("mode", ["HBCEM", "LBIM"])
def test_captured_spec_serve_equals_eager(dev, no_tf32, mode):
    """Self-draft speculation (W8A8): every verify position replays the
    decode graph, each position's logits copied before the next replay."""
    import dataclasses

    from repro_torch.serve.api import SamplingParams

    cfg, cpu = family_pair("llama3-8b", quantized_decode=True)
    samplers = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1), {}, {}, {}, {}]

    def reqs():
        return [dataclasses.replace(r, sampling=SamplingParams(**s))
                for r, s in zip(_serve_requests(), samplers)]

    captured, eager = _graph_ab(cfg, _to(cpu, dev), dev, mode, reqs, spec_k=3)
    _assert_captured_equals_eager(captured, eager)
    assert any(p.spec for p in captured[1])


@pytest.mark.parametrize("spec_k", [None, 2])
def test_captured_preemption_equals_eager(dev, no_tf32, spec_k):
    """A priority preemption and its bit-identical resume, captured."""
    cfg, cpu = family_pair("llama3-8b", quantized_decode=True)
    captured, eager = _graph_ab(
        cfg, _to(cpu, dev), dev, "HBCEM",
        lambda: _serve_requests({2: dict(priority=5)}, PREEMPT_PROMPTS, PREEMPT_BUDGETS),
        spec_k=spec_k)
    _assert_captured_equals_eager(captured, eager)


def _draft_keys_bounded(eng):
    """The draft's keys: one per catch-up length, the chained feed sharing
    length 1's, whatever the number of rounds."""
    sd = eng.spec_dec
    assert 0 < sd.graph_keys() <= len(sd.catchup_lengths | {1})


@pytest.mark.parametrize("mode", ["HBCEM", "LBIM"])
def test_captured_rwkv6_draft_equals_eager(dev, no_tf32, mode):
    """The cross-family pair (an rwkv6 draft, its recurrent state on the
    working lane, for a llama3-8b W8A8 target), captured against eager:
    tokens, plans and launches equal; the draft's keys stay bounded."""
    from repro_torch.core import interleave
    from repro_torch.core.pim_modes import Mode
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve.serving_model import ServingModel
    from repro_torch.serve.spec import SpecConfig

    tcfg, tcpu = family_pair("llama3-8b", quantized_decode=True)
    dcfg, dcpu = family_pair("rwkv6-1.6b")
    target = ServingModel.prepare(tcfg, _to(tcpu, dev), max_len=64, slots=2, device=dev)
    draft = ServingModel.prepare(dcfg, _to(dcpu, dev), max_len=64, slots=2, device=dev)

    def serve():
        eng = target.engine(mode=Mode[mode], chunk=4, spec=SpecConfig(draft=draft, k=3))
        reset_launches()
        res = eng.serve(_serve_requests())
        torch.cuda.synchronize()
        assert eng.pool.check_invariants() == [] and eng.spec_dec.pool.check_invariants() == []
        return ([(r.state, r.tokens) for r in res], [e.plan for e in eng.events],
                launch_counts(), eng.graphs.stats()), eng

    captured, eng = serve()
    _draft_keys_bounded(eng)
    with interleave.eager():
        eager, _ = serve()
    _assert_captured_equals_eager(captured, eager)


def test_captured_spec_draft_feeds_replay(dev, no_tf32):
    """A self-draft spec serve: after each catch-up length's first two calls,
    every draft feed replays (the draft's keys stay bounded, the catch-up and
    chained feeds on one working lane, the anchors never reallocated). No
    prefix reuse, so the second serve runs the first one's steps."""
    from repro_torch.core.pim_modes import Mode
    from repro_torch.serve.serving_model import ServingModel
    from repro_torch.serve.spec import SpecConfig

    cfg, cpu = family_pair("llama3-8b", quantized_decode=True)
    sm = ServingModel.prepare(cfg, _to(cpu, dev), max_len=64, slots=2, device=dev)
    eng = sm.engine(mode=Mode.HBCEM, chunk=4, prefix_cache=False,
                    spec=SpecConfig(draft=sm, k=3))
    eng.serve(_serve_requests())
    sd = eng.spec_dec
    work = sd._work["pos"].data_ptr()
    anchors = {si: a["pos"].data_ptr() for si, a in sd._anchors.items()}
    keys = sd.graph_keys()
    _draft_keys_bounded(eng)
    before = eng.graphs.stats()
    eng.serve(_serve_requests())                 # the same requests again: all replays
    after = eng.graphs.stats()
    assert sd.graph_keys() == keys and after["keys"] == before["keys"]
    assert after["eager_steps"] == before["eager_steps"] and after["replays"] > before["replays"]
    assert sd._work["pos"].data_ptr() == work
    assert {si: a["pos"].data_ptr() for si, a in sd._anchors.items()} == anchors


def test_captured_sampling_equals_eager(dev):
    """The sampling program over a (B, 1, V) slice of a kept verify buffer:
    greedy, sampled, top-k, top-p and done lanes; its first call eager, its
    second captured, the rest replays with new inputs each call, every
    result the eager ``sample_masked``'s (and ``greedy_masked``'s). Logits
    in a buffer nobody keeps are sampled eagerly, with no key."""
    from repro_torch.core import interleave
    from repro_torch.serve import sampling

    b, v = 4, 32000
    g = interleave.StepGraphs(dev)
    buf = torch.empty((b, 4, v), device=dev)
    loose = buf.clone()
    g.keep(buf)
    r = np.random.default_rng(3)
    for call in range(5):
        buf.copy_(torch.from_numpy((3 * r.standard_normal((b, 4, v))).astype(np.float32)))
        lg = buf[:, 1:2]
        done = torch.from_numpy(r.random(b) < 0.25)
        keys = torch.from_numpy(r.integers(0, 2**32, (b, 2)))
        temps = torch.tensor([0.0, 0.8, 1.2, 0.9])
        tks = torch.tensor([0, 50, 0, 5])
        tps = torch.tensor([1.0, 0.95, 0.5, 1.0])
        got = g.sample(lg, done, keys, temps, tks, tps).cpu()
        want = sampling.sample_masked(lg, done, keys=keys, temperature=temps, top_k=tks,
                                      top_p=tps).cpu()
        assert torch.equal(got, want), call
        fast = g.sample(lg, done).cpu()
        assert torch.equal(fast, sampling.greedy_masked(lg, done).cpu()), call
        loose.copy_(buf)
        assert torch.equal(g.sample(loose[:, 1:2], done).cpu(), fast), call
    st = g.stats()
    assert st["keys"] == st["graphs"] == st["captures"] == 2
    assert st["eager_steps"] == 2 and st["replays"] == 8 and st["unheld"] == 5


@pytest.mark.parametrize("arch", _train_archs())
def test_captured_train_step_equals_eager(dev, no_tf32, arch):
    """f32 smoke, the same weights and batches: three in-place steps through
    a ``TrainGraphs`` (a warm-up, a capture, a replay) against three eager
    ones and the functional step: losses, grad norms, params and moments
    bit for bit; the params and moments keep their addresses."""
    from repro_torch.core import interleave
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.train.train_step import TrainGraphs, train_step

    cfg, cpu = family_pair(arch)
    opt = AdamWConfig(warmup_steps=1, total_steps=4, clip_norm=0.5)

    def leaves(p, s):
        return tree_leaves(p) + [s.step] + tree_leaves(s.m) + tree_leaves(s.v)

    def run(captured: bool):
        params = _to(cpu, dev)
        state = init_opt_state(params)
        addrs = [t.data_ptr() for t in leaves(params, state)]
        g = TrainGraphs(dev)
        out = []
        with contextlib.ExitStack() as stack:
            if not captured:
                stack.enter_context(interleave.eager())
            for step in range(3):
                m = g.step(params, state, _train_batch(cfg, "cpu", seed=step), cfg, opt)
                out.append((m["loss"].clone(), m["grad_norm"].clone()))
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in leaves(params, state)] == addrs
        return out, leaves(params, state), g.stats()

    cap, cap_leaves, st = run(True)
    eag, eag_leaves, est = run(False)
    assert st["eager_steps"] == 1 and st["captures"] == 1 and st["replays"] == 2
    assert est["eager_steps"] == 3 and est["captures"] == 0
    assert all(torch.equal(a, b) for x, y in zip(cap, eag) for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(cap_leaves, eag_leaves))
    params = _to(cpu, dev)
    state = init_opt_state(params)
    for step in range(3):
        params, state, m = train_step(params, state, _train_batch(cfg, dev, seed=step), cfg, opt)
        assert torch.equal(m["loss"], cap[step][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(params, state), cap_leaves))


def test_a_host_sync_inside_a_step_fails_its_capture(dev, monkeypatch):
    """A planted ``.item()`` in the decode step: the key's first call runs it
    eagerly, its capture raises ``CaptureError`` naming the planted line, and
    the serve raises (no step falls back to eager). Last in the file: a
    failed capture may leave the process's allocator state behind."""
    from repro_torch.core import interleave
    from repro_torch.core.pim_modes import Mode
    from repro_torch.serve.serving_model import ServingModel

    cfg, cpu = family_pair("llama3-8b")
    real = interleave.M.decode_step

    def planted_host_sync(params, cache, tokens, cfg, **kw):
        int(cache["pos"].reshape(-1)[0].item())
        return real(params, cache, tokens, cfg, **kw)

    monkeypatch.setattr(interleave.M, "decode_step", planted_host_sync)
    eng = ServingModel.prepare(cfg, _to(cpu, dev), max_len=64, slots=2,
                               device=dev).engine(mode=Mode.HBCEM, chunk=4)
    with pytest.raises(interleave.CaptureError, match="planted_host_sync"):
        eng.serve(_serve_requests())
