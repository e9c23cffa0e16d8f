"""Wrappers of the CUDA decode-attention kernels
(``csrc/decode_attention_paged.cu``).

Four kernels, each with a wrapper that takes the plain version from
:mod:`ref` only for CPU tensors and launches the kernel (or raises) for CUDA
tensors, and counts its launches in ``<wrapper>.launches``:

* :func:`decode_attention` — single-pass flash decode over contiguous lanes
  (JAX ``decode_attention``), or over a window of their KV heads (the view
  ``cache[:, j0:j1]`` a rank of the partitioned program reads), in place;
* :func:`decode_attention_paged` — single-pass flash decode over pages (JAX
  ``decode_attention_paged``);
* :func:`split_partials` — stage 1 of the split-KV reduction
  (JAX ``decode_attention_paged_split``'s Pallas call): the single pass's
  chunked walk, one block per (lane, kv head, split), writing every split's
  unnormalized ``(acc, m, l)`` (the identity partial for a dead split) into
  one buffer that the wrapper returns as three views;
* :func:`merge_splits` — stage 2, the associative merge (JAX ``ref.merge_splits``):
  the single pass's chunk merge over all the splits of each row, launched as
  a programmatic dependent of the kernel before it.

:func:`decode_attention_paged_split` chains the last two; each still counts
its own launch.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

_FLOATS = (torch.float32, torch.bfloat16)
# K/V element types and their codes in the C entry points: fp8 e4m3 pages or
# lanes are widened in registers, as the Pallas bodies upcast what they load
_KV_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float8_e4m3fn: 2}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("decode_attention_paged")
    VP, I32, F32 = _build.VP, _build.I32, _build.F32
    lib.decode_chunk_tokens.argtypes = []
    lib.decode_chunk_tokens.restype = I32
    lib.paged_decode_launch.argtypes = [VP] * 8 + [I32] * 7 + [F32, F32] + [I32] * 3 + [VP]
    lib.paged_decode_launch.restype = I32
    lib.paged_split_launch.argtypes = [VP] * 7 + [I32] * 9 + [F32, F32] + [I32] * 3 + [VP]
    lib.paged_split_launch.restype = I32
    lib.merge_splits_launch.argtypes = [VP] * 4 + [I32] * 5 + [VP]
    lib.merge_splits_launch.restype = I32
    lib.contig_decode_launch.argtypes = [VP] * 7 + [I32] * 6 + [F32, F32] + [I32] * 3 + [VP]
    lib.contig_decode_launch.restype = I32
    return lib


def _lane_heads(k: torch.Tensor, v: torch.Tensor) -> Optional[int]:
    """Heads from one lane to the next where contiguous K (B, H, hd, Lmax) and
    V (B, H, Lmax, hd) are windows of H heads of dense lanes (``cache[:,
    j0:j1]``; a whole contiguous cache is its own window), else None."""
    _, h, hd, lmax = k.shape
    ks, vs = k.stride(), v.stride()
    if ks[1:] != (hd * lmax, lmax, 1) or vs[1:] != (lmax * hd, hd, 1) or ks[0] != vs[0] \
            or ks[0] % (hd * lmax) or ks[0] // (hd * lmax) < h:
        return None
    return ks[0] // (hd * lmax)


def _check_inputs(q, k, v, end, start, block_table=None):
    """Shape/type/device checks for the CUDA path, shared by the layouts: paged
    K (P, Hkv, hd, Bsz) / V (P, Hkv, Bsz, hd) with a block table (B, NB), or
    contiguous K (B, Hkv, hd, Lmax) / V (B, Hkv, Lmax, hd) without one.
    q is bf16 or f32; K/V (one dtype) bf16, f32 or fp8 e4m3.
    Returns (int32 table or None, int32 start, int32 end, q, k, v, heads from
    one page or lane to the next), contiguous, but for a contiguous cache's
    window of heads (:func:`_lane_heads`), which is read in place."""
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernels take CUDA tensors, got {q.device}")
    b, hkv, g, hd = q.shape
    paged = block_table is not None
    name, rows, cols = ("pages", "P", "Bsz") if paged else ("cache", b, "Lmax")
    if k.dim() != 4 or k.shape[1] != hkv or k.shape[2] != hd or (not paged and k.shape[0] != b):
        raise ValueError(f"k_{name} {tuple(k.shape)} is not ({rows}, {hkv}, {hd}, {cols})")
    p, _, _, bsz = k.shape
    if tuple(v.shape) != (p, hkv, bsz, hd):
        raise ValueError(f"v_{name} {tuple(v.shape)} is not {(p, hkv, bsz, hd)}")
    if paged and (block_table.dim() != 2 or block_table.shape[0] != b):
        raise ValueError(f"block_table {tuple(block_table.shape)} is not ({b}, NB)")
    if q.dtype not in _FLOATS or k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"unsupported dtypes q {q.dtype}, K/V {k.dtype}/{v.dtype}: q takes "
                        f"{', '.join(map(str, _FLOATS))}; K/V one of "
                        f"{', '.join(map(str, _KV_CODES))}")
    if hd > 256 or g > 16:
        raise ValueError(f"kernel supports hd <= 256 and G <= 16 (got {hd}, {g})")
    dev = q.device
    if any(t.device != dev for t in (k, v) + ((block_table,) if paged else ())):
        raise ValueError("decode attention operands must share one CUDA device")
    end_b = ref._per_lane(end, b, dev, 0).contiguous()
    start_b = ref._per_lane(start, b, dev, 0).contiguous()
    table = block_table.to(torch.int32).contiguous() if paged else None
    heads = None if paged else _lane_heads(k, v)
    if heads is None:
        k, v, heads = k.contiguous(), v.contiguous(), hkv
    return table, start_b, end_b, q.contiguous(), k, v, heads


def _cap(softcap: Optional[float]) -> tuple[float, int]:
    return (float(softcap), 1) if softcap is not None else (1.0, 0)


def _chunk_partials(q: torch.Tensor, span: int) -> Optional[torch.Tensor]:
    """Scratch for the single pass's chunk partials: the kernel splits each
    lane's ``span`` (table width x page size, or Lmax) into fixed chunks and
    merges their (acc, m, l) in a second kernel when there is more than one
    chunk. None (a null pointer) when the span fits one chunk."""
    b, hkv, g, hd = q.shape
    n_chunks = -(-span // _lib().decode_chunk_tokens())
    if n_chunks == 1:
        return None
    return torch.empty(b * hkv * n_chunks * g * (hd + 2), dtype=torch.float32, device=q.device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     end, start=None, *, scale: float,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Single-pass flash decode over contiguous lanes. q (B, Hkv, G, hd); K
    (B, Hkv, hd, Lmax) column-wise; V (B, Hkv, Lmax, hd) row-wise; live range
    ``[start, end)`` per lane. K and V may be a window of Hkv heads of larger
    lanes (``cache[:, j0:j1]``), read in place. Returns (B, Hkv, G, hd)
    float32."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, end, scale, softcap,
                                        start=start)
    _, start_b, end_b, q, k_cache, v_cache, heads = _check_inputs(q, k_cache, v_cache, end,
                                                                  start)
    b, hkv, g, hd = q.shape
    lmax = k_cache.shape[-1]
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    ws = _chunk_partials(q, lmax)
    cap, has_cap = _cap(softcap)
    code = _lib().contig_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start_b.data_ptr(),
        end_b.data_ptr(), out.data_ptr(), _ptr(ws), b, hkv, g, hd, lmax, heads, float(scale),
        cap, has_cap,
        int(q.dtype == torch.float32), _KV_CODES[k_cache.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, end, start=None, *, scale: float,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Single-pass paged flash decode. q (B, Hkv, G, hd); K pages (P, Hkv, hd,
    Bsz) column-wise; V pages (P, Hkv, Bsz, hd) row-wise; block table (B, NB);
    live range ``[start, end)`` per lane. Returns (B, Hkv, G, hd) float32."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged_ref(q, k_pages, v_pages, block_table, end,
                                              scale, softcap, start=start)
    table, start_b, end_b, q, k_pages, v_pages, _ = _check_inputs(
        q, k_pages, v_pages, end, start, block_table)
    b, hkv, g, hd = q.shape
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    ws = _chunk_partials(q, table.shape[1] * k_pages.shape[-1])
    cap, has_cap = _cap(softcap)
    code = _lib().paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        start_b.data_ptr(), end_b.data_ptr(), out.data_ptr(), _ptr(ws), b, hkv, g, hd,
        k_pages.shape[-1], table.shape[1], k_pages.shape[0], float(scale), cap, has_cap,
        int(q.dtype == torch.float32), _KV_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


def split_partials(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                   block_table: torch.Tensor, end, start=None, *, num_splits: int,
                   scale: float, softcap: Optional[float] = None):
    """Stage 1 of the split-KV reduction over ``S_real`` realized splits.
    Returns acc (B, Hkv, S, G, hd), m and l (B, Hkv, S, G), all float32."""
    if q.device.type == "cpu":
        return ref.split_partials_ref(q, k_pages, v_pages, block_table, end, num_splits,
                                      scale, softcap, start=start)
    table, start_b, end_b, q, k_pages, v_pages, _ = _check_inputs(
        q, k_pages, v_pages, end, start, block_table)
    b, hkv, g, hd = q.shape
    bps, n_splits = ref.realized_splits(table.shape[1], num_splits)
    # one buffer, as the kernel writes it: acc, then m, then l
    n = b * hkv * n_splits * g
    parts = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    cap, has_cap = _cap(softcap)
    code = _lib().paged_split_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        start_b.data_ptr(), end_b.data_ptr(), parts.data_ptr(), b, hkv, g, hd,
        k_pages.shape[-1], table.shape[1], k_pages.shape[0], bps, n_splits, float(scale),
        cap, has_cap, int(q.dtype == torch.float32), _KV_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention_paged_split")
    split_partials.launches += 1
    acc, m, l = parts.split([n * hd, n, n])
    return (acc.view(b, hkv, n_splits, g, hd), m.view(b, hkv, n_splits, g),
            l.view(b, hkv, n_splits, g))


def merge_splits(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Stage 2: merge (B, Hkv, S, G, hd) partials into (B, Hkv, G, hd) float32."""
    if acc.device.type == "cpu":
        return ref.merge_splits(acc, m, l)
    if acc.device.type != "cuda":
        raise ValueError(f"merge_splits kernel takes CUDA tensors, got {acc.device}")
    b, hkv, s, g, hd = acc.shape
    if tuple(m.shape) != (b, hkv, s, g) or tuple(l.shape) != (b, hkv, s, g):
        raise ValueError("merge_splits: m/l must be (B, Hkv, S, G)")
    if not all(t.dtype == torch.float32 and t.device == acc.device for t in (acc, m, l)):
        raise TypeError("merge_splits takes float32 partials on one device")
    acc, m, l = acc.contiguous(), m.contiguous(), l.contiguous()
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=acc.device)
    code = _lib().merge_splits_launch(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), b, hkv, s, g, hd,
        torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(code, "merge_splits")
    merge_splits.launches += 1
    return out


def decode_attention_paged_split(q, k_pages, v_pages, block_table, end, start=None, *,
                                 num_splits: int, scale: float,
                                 softcap: Optional[float] = None) -> torch.Tensor:
    """Paged flash decode with the two-stage split-KV reduction."""
    acc, m, l = split_partials(q, k_pages, v_pages, block_table, end, start,
                               num_splits=num_splits, scale=scale, softcap=softcap)
    return merge_splits(acc, m, l)


decode_attention.launches = 0
decode_attention_paged.launches = 0
split_partials.launches = 0
merge_splits.launches = 0
