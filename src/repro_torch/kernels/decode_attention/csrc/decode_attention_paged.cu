// Flash decode over the CD-PIM dual-layout KV cache, paged or contiguous, for
// Hopper (sm_90a).
//
// Replaces four pieces of the JAX package:
//   * the Pallas kernel `decode_attention_paged`
//     (src/repro/kernels/decode_attention/decode_attention.py:165; body `_paged_kernel`
//     :153 -> `_decode_attn_kernel` :46): single-pass online-softmax decode (B1);
//   * the Pallas kernel `decode_attention_paged_split` (:309; `_split_kernel` :244,
//     `_clamp_split` :296): stage 1 of the split-KV reduction, one unnormalized
//     (acc, m, l) partial per split (B2);
//   * `merge_splits` (src/repro/kernels/decode_attention/ref.py:72), stage 2;
//   * the Pallas kernel `decode_attention` (:102, the same `_decode_attn_kernel` body):
//     single-pass decode over contiguous lanes, K (B, Hkv, hd, Lmax) column-wise and
//     V (B, Hkv, Lmax, hd) row-wise, as the contiguous CachePool and the hybrid
//     (zamba2) shared block hold them (B4).
//
// Bound on the H100: the live K/V bytes. Every live cache element is read once and
// used for G (1 for zamba2, 4 for llama3-8b) multiply-adds in each of the two GEMVs,
// so the kernel is a cache stream at 3.35 TB/s: (end - start) * Hkv * hd * 2 tensors
// * 2 bytes per lane and layer.
//
// B1 and B4: the chunked single pass (`chunk_body`). What held the earlier body (a
// thread-block cluster per (lane, kv head), each warp loading its token's K column
// as 2-byte loads) back on this card, and what this design does about it:
//   * Parallel work followed the capacity: a cluster as large as a full block table,
//     whose empty blocks still met at two cluster barriers. Here each block takes one
//     chunk of kChunk tokens of one (lane, kv head) at absolute token positions, and a
//     block whose chunk misses the live range [start, end) returns at once, before
//     any barrier. The grid comes from the shapes alone (chunks of the table's span
//     or Lmax, times B * Hkv), so nothing is read back to the host.
//   * Few bytes were in flight: 2-byte loads in some 15 dependent rounds a tile. Here
//     each warp of a block walks its own 32-token tiles of the chunk, each moved into
//     a ring of shared-memory stages by the copy engine and completing on an
//     mbarrier, so a tile's copies are in flight while the warp works on the one
//     before. The paper's section III-C mapping is what makes the copies wide: a K
//     page is column-wise (hd, Bsz) and a V page row-wise (Bsz, hd), so a (page, kv
//     head) K block is one contiguous run (one bulk copy, `cp.async.bulk`), the K of
//     a tile on a contiguous lane is one box of hd rows of 32 tokens, and V is rows of
//     hd (tensor copies, `cp.async.bulk.tensor`, in boxes of 64 d). On the card, many
//     small copies cost more than the bytes: 16-byte `cp.async` stalls the issuing
//     warp once the SM's outstanding loads are full, and a bulk copy per 64-byte K
//     row keeps the copy engine busy for microseconds a tile; boxes (one K copy and
//     one per 64 d of V a tile) took that cost away.
//   * The score and output GEMVs ran on the CUDA cores, about 2,000 instructions a
//     tile for one warp. Here, for bf16 q and K/V with 64 <= hd <= 128, hd % 16 == 0,
//     they run on the tensor cores (mma.sync m16n8k16, f32 accumulators): S = Q K
//     with the query heads as the 16 rows (zeros past G), then O += P V with P split
//     into a bf16 pair hi + lo, which keeps about 16 bits of each probability (the
//     plain version's f32 result within rtol 1e-4). K and V are read with ldmatrix
//     from swizzled rows (chunk c of a 64-byte K row d at c ^ ((d >> 1) & 3), of a
//     128-byte V row t at c ^ (t & 7)), free of bank conflicts; the k and d steps
//     past hd re-read the last rows (against q = 0, or into columns never stored),
//     so no step branches and each tile schedules as one block of code. Other
//     shapes (f32, hd < 64 or > 128, runs not 16-byte aligned such as Lmax % 8 != 0
//     in bf16, lanes under 32 tokens, pages of other than 8, 16 or a multiple of 32
//     tokens) take the CUDA-core walk over the same tiles, loaded with plain loads:
//     one token per lane for the scores, one d per lane for the output.
//   * The merge read remote shared memory serially. Here the warps of a block merge
//     through shared memory, then a small second kernel merges the chunks' partials
//     of each (lane, kv head, query head) in chunk order, reading only the live
//     chunks; it is launched as a programmatic dependent of the chunk kernel, so its
//     blocks wait on the card rather than behind a launch. Where the table's span or
//     Lmax fits one chunk, the chunk kernel writes the normalized output itself and
//     the second kernel is not launched. Either way the wrapper counts one launch.
//   * A lane's result depends on its q, its cache, its range and the table's span (or
//     Lmax) only: the chunks sit at absolute positions, each warp walks its tiles in a
//     fixed order, and every merge runs in a fixed order with no atomics. So a lane
//     computed alone or inside a batch gives bit-identical output.
//
// B2 runs on the same body and the same merge. Its earlier stage 1 was B1's earlier
// design (a cluster of up to 8 blocks per (lane, kv head, split), 2-byte loads of K
// one token per lane, CUDA-core GEMVs, a merge through distributed shared memory) and
// took 2.8x B1's time on the same work. A split is not a chunk: split s is the bps *
// Bsz tokens from s * bps * Bsz (the caller applies the realized-split rule bps =
// ceil(NB/S), S_real = ceil(NB/bps)), 80 tokens at the 4-split serve's 37-block
// tables and 512 at 256-block ones. Each (lane, kv head, split) is one block of the
// chunked walk (kSplit) whose range is the split clipped to [start, end): its tiles
// keep their absolute 32-token positions, so a tile that a split boundary cuts is
// copied by both splits' blocks and each keeps its own rows through fill_tile's live
// range. One launch per call; 256-token pieces of a split reduced by a third kernel
// would have doubled the live blocks at long splits but added a launch to every
// call. A split walks more tiles than a chunk, so its blocks take eight warps where
// K/V are bf16 (four for f32, whose stages would not fit). A block always writes
// the unnormalized (acc, m, l) of its split, never the normalized output, and a dead
// split writes the identity partial before it returns. That acc is held to the f32
// plain version on its own, so P enters the tensor cores as three bf16 pieces (all
// 24 bits) where the single pass takes two. Stage 2 is the chunk merge over all S
// parts of each row (no live range is passed): max first, then the sums in split
// order, launched as a programmatic dependent of the kernel before it. As in the
// single pass, a lane's partials depend on its own inputs, the table width and S
// only.
//
// Online softmax in f32 with the finite NEG_INF = -2.3819763e38 of the JAX package.
// An empty range (end <= start) gives exact zeros through the l > 0 guard. A dead
// split carries the identity partial (m = NEG_INF, l = 0, acc = 0), and the merge of
// an all-dead lane gives zeros, not NaN, because exp(NEG_INF - NEG_INF) = 1 is
// multiplied by l = 0.
//
// K/V types: bf16, f32, or fp8 e4m3 (``kv_dtype="float8_e4m3fn"``, as the Pallas bodies
// take it: they upcast whatever K/V they load, :63-65, :265-267). An fp8 tile takes
// the CUDA-core walk: plain loads of one byte an element into the stages, widened to
// f32 in registers (e4m3 -> f32 is exact), so the arithmetic is the f32 walk's over
// the same values. The copy-engine boxes and the tensor-core walk are bf16 only.
//
// A window of heads (B4): a rank of the partitioned program attends with its query
// heads over a window of its lanes' KV heads, a view k[:, j0:j1] whose lanes lie
// lane_heads heads apart. The kernel addresses (lane, head) rows as lane * lane_heads
// + head from the window's first head, and its tensor maps span the rows from the
// first window's first head to the last window's last, so the window is read in place:
// no copy of it is made (one of llama3-8b's decode_32k rank would be 134 MB a layer).
//
// Limits: hd <= 256, G <= 16, any page size Bsz or Lmax. G == 1 and G <= 4 with
// hd <= 128 take narrow instantiations (zamba2: G 1, hd 112; llama3-8b: G 4, hd 128),
// the rest a wide one on the CUDA cores. A query head beyond G holds zeros and is
// never stored; a d beyond hd is never stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kTile = 32;        // tokens of a tile: one per lane in the score GEMV
constexpr int kChunk = 256;      // tokens of one block of the single pass
constexpr int kBarBytes = 128;   // the mbarriers, ahead of q in shared memory
constexpr int kSmPerSm = 233472; // shared memory of one SM (228 KB)
constexpr int kSmemPerBlock = 232448;  // the most one block may take (227 KB)
constexpr int kBlockReserve = 1024;    // the SM's own shared memory per resident block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one contiguous run global -> shared by the bulk-copy engine, counted on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 2-D tensor map at element (x, y) -> shared memory, counted on ``bar``
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// expect ``bytes`` more of bulk copies before the current phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// The chunked walk: B1 and B4 (single pass), B2 stage 1 (split partials)
// ---------------------------------------------------------------------------

// Geometry of one launch, the same for every block.
struct ChunkGeom {
  int hkv, g, hd;
  int lane_heads;     // heads from one page or lane to the next in memory: Hkv, or more
                      // where the kernel reads a window of a lane's heads (B4)
  int bsz, nb;        // page size and table width; contiguous lanes: Lmax and 1
  int n_chunks;       // blocks per (lane, kv head): ceil(nb * bsz / kChunk), or the splits
  int span;           // splits: tokens of one split, bps * bsz (the single pass: kChunk)
  int tma;            // 1: copy engine and tensor cores; 0: plain loads and CUDA cores
  int stages;         // ring depth per warp (1 or 2)
  int pw, pw_log2;    // tensor copies: tokens of one K piece, Bsz where it divides 32, else 32
  int kps;            // elements from one K page block to the next (padded)
  int kt_bytes;       // K part of a stage (the V part follows)
  int stage_bytes;    // K and V of one tile
  int q_bytes;        // q in shared memory for the CUDA-core walk, f32 (hdp, kG)
  int n_vcb;          // tensor copies: V column blocks of 64 d, each 32 rows of 128 bytes
  float scale, softcap;
  int has_cap;
};

#define REPRO_CHUNK_PARAMS                                                                 \
  const TQ* __restrict__ q, const TKV* __restrict__ kc, const TKV* __restrict__ vc,        \
      const int* __restrict__ table, const int* __restrict__ start,                        \
      const int* __restrict__ end, float* __restrict__ out, float* __restrict__ ws,        \
      const ChunkGeom geo
#define REPRO_CHUNK_ARGS q, kc, vc, table, start, end, out, ws, geo, tmk, tmv

// Start moving tile [t0, t0 + 32) of (lane b, kv head h) into stage ``st``; the
// live tokens of the tile are [a, e). With copies, lane 0 announces the tile's bytes
// on ``bar`` and the lanes issue them; every lane arrives once (after its stores,
// for plain loads).
template <typename TKV, bool kPaged>
__device__ __forceinline__ void fill_tile(const TKV* __restrict__ kc, const TKV* __restrict__ vc,
                                          const int* __restrict__ table, const ChunkGeom& geo,
                                          const CUtensorMap* tmk, const CUtensorMap* tmv,
                                          int b, int h, int t0, int a, int e,
                                          unsigned char* st, uint64_t* bar, int lane) {
  constexpr int esz = static_cast<int>(sizeof(TKV));
  char* ksb = reinterpret_cast<char*>(st);
  char* vsb = reinterpret_cast<char*>(st + geo.kt_bytes);
  const int hd = geo.hd, bsz = geo.bsz;
  const int64_t row0 = static_cast<int64_t>(b) * geo.nb;
  if (geo.tma) {
    // V (cols 64 x, rows of the page or lane): one tensor copy per 128-byte column
    // block and page (or tile), swizzled by 128 bytes; K: one tensor copy of (32
    // tokens, hd) swizzled by 64 bytes, or one bulk copy per page block
    const int nvb = geo.n_vcb;
    if (geo.pw == kTile) {
      const int64_t page = kPaged ? table[row0 + t0 / bsz] : b;
      const int off = kPaged ? t0 % bsz : t0;
      if (lane == 0)
        mbar_expect_tx(bar, static_cast<uint32_t>(kTile * hd * esz + nvb * kTile * 128));
      __syncwarp();
      if (lane == 0) tma_2d(ksb, tmk, off, static_cast<int>((page * geo.lane_heads + h) * hd), bar);
      if (lane >= 1 && lane <= nvb)
        tma_2d(vsb + (lane - 1) * kTile * 128, tmv, (lane - 1) * 64,
               static_cast<int>((page * geo.lane_heads + h) * bsz + off), bar);
    } else {
      const int jlo = (a - t0) >> geo.pw_log2, jhi = (e - t0 + bsz - 1) >> geo.pw_log2;
      const uint32_t krun = static_cast<uint32_t>(hd * bsz * esz);
      const int64_t page =
          lane >= jlo && lane < jhi ? table[row0 + (t0 >> geo.pw_log2) + lane] : 0;
      if (lane == 0)
        mbar_expect_tx(bar, (krun + static_cast<uint32_t>(nvb * bsz * 128)) *
                                static_cast<uint32_t>(jhi - jlo));
      __syncwarp();
      if (lane >= jlo && lane < jhi) {
        bulk_copy(ksb + static_cast<int64_t>(lane) * geo.kps * esz,
                  kc + (page * geo.lane_heads + h) * static_cast<int64_t>(hd) * bsz, krun, bar);
        for (int cb = 0; cb < nvb; ++cb)
          tma_2d(vsb + cb * kTile * 128 + lane * bsz * 128, tmv, cb * 64,
                 static_cast<int>((page * geo.lane_heads + h) * bsz), bar);
      }
    }
    mbar_arrive(bar);
    return;
  }
  // plain loads of the live tokens into K (hd, 32) and V (32, hd): lane t owns
  // token t0 + t of K, the warp walks the V rows
  TKV* ks = reinterpret_cast<TKV*>(ksb);
  TKV* vs = reinterpret_cast<TKV*>(vsb);
  const int tok = t0 + lane;
  if (tok >= a && tok < e) {
    const int64_t page = kPaged ? table[row0 + tok / bsz] : b;
    const int off = kPaged ? tok % bsz : tok;
    const TKV* kcol = kc + (page * geo.lane_heads + h) * static_cast<int64_t>(hd) * bsz + off;
    for (int d = 0; d < hd; ++d) ks[d * kTile + lane] = kcol[static_cast<int64_t>(d) * bsz];
  }
  for (int t = a - t0; t < e - t0; ++t) {
    const int tk = t0 + t;
    const int64_t page = kPaged ? table[row0 + tk / bsz] : b;
    const int off = kPaged ? tk % bsz : tk;
    const TKV* vrow = vc + ((page * geo.lane_heads + h) * static_cast<int64_t>(bsz) + off) * hd;
    for (int d = lane; d < hd; d += 32) vs[t * hd + d] = vrow[d];
  }
  mbar_arrive(bar);   // release: the waiting lanes see the stores
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x, y as kPieces bf16 pairs, each of what the ones before leave out, so that a
// product with a bf16 operand keeps about 8 * kPieces bits of x and y (two pieces:
// 16 bits; three: all 24 of an f32)
// into register ``reg`` of each piece's A fragment
template <int kPieces>
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t (&pieces)[kPieces][4],
                                           int reg) {
#pragma unroll
  for (int i = 0; i < kPieces - 1; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    pieces[i][reg] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
  pieces[kPieces - 1][reg] = pack_bf16(x, y);
}

// One block: chunk blockIdx.x of (lane, kv head) blockIdx.y, or with kSplit split
// blockIdx.x. kG: query heads per kv head held in registers (>= G); kDC: 32-wide d
// chunks per lane (>= hd / 32).
template <typename TQ, typename TKV, int kG, int kDC, int kWarps, bool kPaged, bool kSplit>
__device__ __forceinline__ void chunk_body(REPRO_CHUNK_PARAMS, const CUtensorMap& tmk,
                                           const CUtensorMap& tmv) {
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = blockIdx.x;
  const int bh_i = blockIdx.y;   // b * Hkv + h
  const int b = bh_i / geo.hkv;
  const int h = bh_i - b * geo.hkv;
  const int64_t bh = bh_i;
  const int g = geo.g, hd = geo.hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the merge kernel may launch now and wait for this grid's writes (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");

  // live tokens of this chunk or split
  const int span = kSplit ? geo.span : kChunk;
  const int lo = max(start[b], c * span);
  const int hi = min(min(end[b], geo.nb * geo.bsz), (c + 1) * span);
  if (lo >= hi) {
    if constexpr (kSplit) {   // a dead split: the identity partial
      const int64_t part = bh * geo.n_chunks + c;
      const int64_t n_parts = static_cast<int64_t>(gridDim.y) * geo.n_chunks;
      for (int i = tid; i < g * hd; i += kWarps * 32) ws[part * g * hd + i] = 0.f;
      if (tid < g) {
        ws[n_parts * g * hd + part * g + tid] = kNegInf;
        ws[n_parts * g * (hd + 1) + part * g + tid] = 0.f;
      }
    } else if (geo.n_chunks == 1) {   // the block is the lane's whole pass: zeros
      for (int i = tid; i < g * hd; i += kWarps * 32) out[bh * g * hd + i] = 0.f;
    }
    return;
  }

  // stages start on a 1024-byte boundary, as the 128-byte swizzle of tensor copies needs
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);          // (kWarps, stages)
  float* qs = reinterpret_cast<float*>(base + kBarBytes);       // (hdp, kG)
  unsigned char* stage0 = base + round_up(kBarBytes + geo.q_bytes, 1024);   // (kWarps, stages)
  const int stages = geo.stages;
  uint64_t* wbar = bars + warp * stages;
  unsigned char* wst = stage0 + static_cast<size_t>(warp) * stages * geo.stage_bytes;

  // this warp's tiles: i = warp, warp + kWarps, ... of the chunk's live tiles
  const int t_first = lo & ~(kTile - 1);
  const int n_tiles = (hi - t_first + kTile - 1) / kTile;
  const int n_my = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  auto tile_start = [&](int j) { return t_first + (warp + j * kWarps) * kTile; };
  auto fill = [&](int j) {
    const int t0 = tile_start(j);
    const int slot = j % stages;
    fill_tile<TKV, kPaged>(kc, vc, table, geo, &tmk, &tmv, b, h, t0, max(lo, t0),
                           min(hi, t0 + kTile),
                           wst + static_cast<size_t>(slot) * geo.stage_bytes, wbar + slot, lane);
  };
  // wait for tile j and hand its stage to ``body(ta, tb, ks, vs)``, the live rows
  // of the tile being [ta, tb); then refill the stage with tile j + stages
  auto walk = [&](auto&& body) {
    for (int j = 0; j < n_my; ++j) {
      const int slot = j % stages;
      mbar_wait(wbar + slot, static_cast<uint32_t>((j / stages) & 1));
      const unsigned char* st = wst + static_cast<size_t>(slot) * geo.stage_bytes;
      const int t0 = tile_start(j);
      body(max(lo, t0) - t0, min(hi, t0 + kTile) - t0, reinterpret_cast<const TKV*>(st),
           reinterpret_cast<const TKV*>(st + geo.kt_bytes));
      __syncwarp();   // every lane is done with the stage before it is refilled
      if (j + stages < n_my) {
        // order this warp's plain accesses to the stage before the copies into it
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        fill(j + stages);
      }
    }
  };

  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(wbar + s, 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int j = 0; j < min(stages, n_my); ++j) fill(j);   // the copies start before q is read

  // per-warp partials go through the (then idle) stages: (kWarps, kG, hd), m, l
  float* wacc = reinterpret_cast<float*>(stage0);
  float* wm = wacc + kWarps * kG * hd;
  float* wl = wm + kWarps * kG;
  bool walked = false;

  if constexpr (std::is_same<TQ, __nv_bfloat16>::value &&
                std::is_same<TKV, __nv_bfloat16>::value && kDC == 4) {
    if (geo.tma) {
      // Tensor cores, m16n8k16: S (query heads x 32 tokens) = Q K over 16-wide d
      // steps, then O (query heads x hd) += P V over two 16-token steps, in f32.
      // The rows of the m16 tiles are query heads; with G <= 4 only rows 0-7 (a
      // lane's row grp) are ever nonzero, so rows 8-15 are fed zeros and dropped.
      // P enters as bf16 pieces: two (16 bits kept) where the output is normalized
      // or merged; three (all 24) for split partials, whose unnormalized acc is
      // held to f32 accuracy on its own.
      static_assert(kG <= 8, "the tensor-core walk keeps one row of each m16 tile");
      constexpr int kKS = 8, kND = 16;    // hd <= 128: 16-wide d steps, 8-wide d blocks
      constexpr int kPieces = kSplit ? 3 : 2;
      const int grp = lane >> 2, t4 = lane & 3;
      const int n_ks = hd / 16, n_nd = hd / 8;
      uint32_t qa[kKS][4];   // A fragments of q: rows grp (regs 0, 2), rows grp + 8 zero
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = ks * 16 + (i >> 1) * 8 + 2 * t4;
          qa[ks][i] = (i & 1) == 0 && ks < n_ks && grp < g
                          ? *reinterpret_cast<const uint32_t*>(q + (bh * g + grp) * hd + col)
                          : 0u;
        }
      float o[kND][4], mrow = kNegInf, lrow = 0.f;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
      // Byte offsets of the row each lane hands to ldmatrix. K as one box (hd rows
      // of 32 tokens, 64 bytes, the 16-byte chunk c of row d at c ^ ((d >> 1) & 3))
      // or as page blocks (hd rows of Bsz tokens, padded apart); V as column blocks
      // of (32 rows of 64 d, 128 bytes), chunk c of row t at c ^ (t & 7).
      const int mat = lane >> 3, r8 = lane & 7;
      const int k_r = (mat & 1) * 8 + r8;   // d within a 16-wide step; token row within 16
      const bool k_box = geo.pw == kTile;
      int k_off[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tok = 16 * half + 8 * (mat >> 1);
        k_off[half] = k_box ? k_r * 64 + (((tok >> 3) ^ ((r8 >> 1) & 3)) << 4)
                            : ((tok >> geo.pw_log2) * geo.kps + (tok & (geo.pw - 1)) +
                               k_r * geo.bsz) * 2;
      }
      const int k_step = k_box ? 16 * 64 : 16 * geo.bsz * 2;   // bytes of a 16-wide d step

      walk([&](int ta, int tb, const TKV* ks_p, const TKV* vs_p) {
        const char* kb = reinterpret_cast<const char*>(ks_p);
        char* vb = const_cast<char*>(reinterpret_cast<const char*>(vs_p));
        if (ta > 0 || tb < kTile) {
          // rows of dead tokens may hold anything, and p = 0 must not meet a NaN
          for (int r = 0; r < kTile; ++r)
            if ((r < ta || r >= tb) && lane < 8 * geo.n_vcb)
              *reinterpret_cast<uint4*>(vb + (lane >> 3) * kTile * 128 + r * 128 +
                                        (lane & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
          __syncwarp();
        }
        float s[4][4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
        // no branch on hd in the unrolled steps, so they schedule as one block: a
        // step past hd reads the last K rows again, against q = 0
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          const int k_at = min(ks, n_ks - 1) * k_step;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, kb + k_off[half] + k_at);
            mma_bf16(s[2 * half], qa[ks], bb[0], bb[1]);
            mma_bf16(s[2 * half + 1], qa[ks], bb[2], bb[3]);
          }
        }
        // online softmax over the tile's 32 tokens of row grp: token 8 nb + 2 t4 + e
        // sits in s[nb][e] of lane (grp, t4), a row's values in the four lanes of a quad
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) s[nb][e] *= geo.scale;
        if (geo.has_cap) {
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) s[nb][e] = geo.softcap * tanhf(s[nb][e] / geo.softcap);
        }
        float mx = kNegInf;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * nb + 2 * t4 + e;
            s[nb][e] = t >= ta && t < tb ? s[nb][e] : kNegInf;
            mx = fmaxf(mx, s[nb][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(mrow, mx);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * nb + 2 * t4 + e;
            s[nb][e] = t >= ta && t < tb ? expf(s[nb][e] - m_new) : 0.f;
            sum += s[nb][e];
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        const float alpha = expf(mrow - m_new);
        lrow = lrow * alpha + sum;
        mrow = m_new;
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          o[nd][0] *= alpha;
          o[nd][1] *= alpha;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // A fragments of P (tokens 16 kk .. 16 kk + 15): s[2 kk] and s[2 kk + 1]
          uint32_t pp[kPieces][4] = {};
          split_bf16<kPieces>(s[2 * kk][0], s[2 * kk][1], pp, 0);
          split_bf16<kPieces>(s[2 * kk + 1][0], s[2 * kk + 1][1], pp, 2);
          // d blocks past hd read the last one again into columns never stored
#pragma unroll
          for (int nd = 0; nd < kND; nd += 2) {
            uint32_t bb[4];
            const int ndm = min(nd + (mat >> 1), n_nd - 1);
            ldsm_x4_trans(bb, vb + (ndm >> 3) * kTile * 128 + (kk * 16 + k_r) * 128 +
                                  (((ndm & 7) ^ r8) << 4));
#pragma unroll
            for (int pc = 0; pc < kPieces; ++pc) mma_bf16(o[nd], pp[pc], bb[0], bb[1]);
#pragma unroll
            for (int pc = 0; pc < kPieces; ++pc) mma_bf16(o[nd + 1], pp[pc], bb[2], bb[3]);
          }
        }
      });

      __syncthreads();   // every warp is done with its stages
      if (grp < g) {
        if (t4 == 0) {
          wm[warp * kG + grp] = mrow;
          wl[warp * kG + grp] = lrow;
        }
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          if (nd < n_nd) {
            float* dst = wacc + (warp * kG + grp) * hd + nd * 8 + 2 * t4;
            dst[0] = o[nd][0];
            dst[1] = o[nd][1];
          }
        }
      }
      walked = true;
    }
  }

  if (!walked) {
    // CUDA cores: lane t scores token t of the tile, lane d accumulates d
    const int hdp = (hd + 7) / 8 * 8;
    for (int i = tid; i < hdp * kG; i += kWarps * 32) {
      const int d = i / kG, gi = i - d * kG;
      qs[i] = (d < hd && gi < g) ? to_f(q[(bh * g + gi) * hd + d]) : 0.f;
    }
    __syncthreads();
    float m[kG], l[kG], acc[kG][kDC];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      m[gi] = kNegInf;
      l[gi] = 0.f;
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) acc[gi][cc] = 0.f;
    }
    walk([&](int ta, int tb, const TKV* ks_p, const TKV* vs) {
      const TKV* kcol = ks_p + lane;
      const bool valid = lane >= ta && lane < tb;
      // score GEMV, outer-product flow: this lane's token against the G queries
      float s[kG];
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) s[gi] = 0.f;
      for (int d0 = 0; d0 < hd; d0 += 8) {
        float kr[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) kr[u] = d0 + u < hd ? to_f(kcol[(d0 + u) * kTile]) : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float* qd = qs + (d0 + u) * kG;
#pragma unroll
          for (int gi = 0; gi < kG; ++gi) s[gi] += qd[gi] * kr[u];
        }
      }
      // online-softmax update; m and l are the same in every lane of the warp
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        float x = s[gi] * geo.scale;
        if (geo.has_cap) x = geo.softcap * tanhf(x / geo.softcap);
        x = valid ? x : kNegInf;
        const float m_new = fmaxf(m[gi], warp_max(x));
        const float p = valid ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[gi] - m_new);
        l[gi] = l[gi] * alpha + warp_sum(p);
        m[gi] = m_new;
        s[gi] = p;
#pragma unroll
        for (int cc = 0; cc < kDC; ++cc) acc[gi][cc] *= alpha;
      }
      // output GEMV, inner-product flow: lane d walks the tile's live V rows
      for (int t = ta; t < tb; t += 4) {
        float vr[4][kDC];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int cc = 0; cc < kDC; ++cc) {
            const int d = lane + 32 * cc;
            vr[u][cc] = (t + u < tb && d < hd) ? to_f(vs[(t + u) * hd + d]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int gi = 0; gi < kG; ++gi) {
            const float p = __shfl_sync(kFull, s[gi], (t + u) & 31);
#pragma unroll
            for (int cc = 0; cc < kDC; ++cc) acc[gi][cc] += p * vr[u][cc];
          }
        }
      }
    });

    __syncthreads();   // every warp is done with its stages
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      if (lane == 0) {
        wm[warp * kG + gi] = m[gi];
        wl[warp * kG + gi] = l[gi];
      }
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) {
        const int d = lane + 32 * cc;
        if (d < hd && gi < g) wacc[(warp * kG + gi) * hd + d] = acc[gi][cc];
      }
    }
  }

  // merge the warps of this block, in warp order
  __syncthreads();
  const int64_t n_parts = static_cast<int64_t>(gridDim.y) * geo.n_chunks;
  for (int i = tid; i < g * hd; i += kWarps * 32) {
    const int gi = i / hd, d = i - gi * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kG + gi]);
    float lt = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float al = expf(wm[w * kG + gi] - mx);
      lt += wl[w * kG + gi] * al;
      o += wacc[(w * kG + gi) * hd + d] * al;
    }
    if (!kSplit && geo.n_chunks == 1) {
      out[bh * g * hd + i] = o / (lt > 0.f ? lt : 1.f);
    } else {   // partials (B * Hkv, n_chunks, G, hd), then m and l (B * Hkv, n_chunks, G)
      const int64_t part = bh * geo.n_chunks + c;
      ws[part * g * hd + i] = o;
      if (d == 0) {
        ws[n_parts * g * hd + part * g + gi] = mx;
        ws[n_parts * g * (hd + 1) + part * g + gi] = lt;
      }
    }
  }
}

// Merge the partials of one (lane, kv head, query head) in part order, one thread
// per d: the chunks that the live range [start, end) touches, or, with start null,
// all n_chunks parts (the splits). Max first, then the sums; a row with no live part
// gives zeros, since exp(NEG_INF - NEG_INF) = 1 meets l = 0.
__device__ __forceinline__ void chunk_merge_body(const float* __restrict__ acc,
                                                 const float* __restrict__ m,
                                                 const float* __restrict__ l,
                                                 const int* __restrict__ start,
                                                 const int* __restrict__ end,
                                                 float* __restrict__ out, int hkv, int g, int hd,
                                                 int cap, int n_chunks) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the partials' kernel is done
  const int row = blockIdx.x;   // (b * Hkv + h) * G + gi
  const int bh = row / g, gi = row - bh * g;
  const int d = threadIdx.x;
  int c_lo = 0, c_hi = n_chunks;
  if (start != nullptr) {
    const int b = bh / hkv;
    const int lo = max(start[b], 0), hi = min(end[b], cap);
    c_lo = lo / kChunk;
    c_hi = hi > lo ? (hi + kChunk - 1) / kChunk : c_lo;
  }
  // this row's parts: part c's m and l at c * G past mr and lr, its acc at c * G * hd
  // past ar
  const int64_t first = static_cast<int64_t>(bh) * n_chunks * g + gi;
  const float* mr = m + first;
  const float* lr = l + first;
  const float* ar = acc + first * hd + d;
  const int64_t step = static_cast<int64_t>(g) * hd;
  float mx = kNegInf;
  for (int c = c_lo; c < c_hi; ++c) mx = fmaxf(mx, mr[c * g]);
  float lt = 0.f, o = 0.f;
  for (int c = c_lo; c < c_hi; ++c) {
    const float al = expf(mr[c * g] - mx);
    lt += lr[c * g] * al;
    if (d < hd) o += ar[c * step] * al;
  }
  if (d < hd) out[static_cast<int64_t>(row) * hd + d] = o / (lt > 0.f ? lt : 1.f);
}

// B1 (kSplit false) and B2 stage 1 (kSplit true): pages through a block table.
template <typename TQ, typename TKV, int kG, int kDC, int kWarps, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(REPRO_CHUNK_PARAMS, const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv) {
  chunk_body<TQ, TKV, kG, kDC, kWarps, true, kSplit>(REPRO_CHUNK_ARGS);
}

// B4: contiguous lanes (``table`` is not read). Kernels of their own names, so a
// profile tells them from the paged ones.
template <typename TQ, typename TKV, int kG, int kDC, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    contig_decode_kernel(REPRO_CHUNK_PARAMS, const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv) {
  chunk_body<TQ, TKV, kG, kDC, kWarps, false, false>(REPRO_CHUNK_ARGS);
}

#define REPRO_MERGE_PARAMS                                                                \
  const float* __restrict__ acc, const float* __restrict__ m, const float* __restrict__ l, \
      const int* __restrict__ start, const int* __restrict__ end, float* __restrict__ out, \
      int hkv, int g, int hd, int cap, int n_chunks

// The merges of B1 and B2 (stage 2), and of B4.
__global__ void paged_decode_merge_kernel(REPRO_MERGE_PARAMS) {
  chunk_merge_body(acc, m, l, start, end, out, hkv, g, hd, cap, n_chunks);
}

__global__ void contig_decode_merge_kernel(REPRO_MERGE_PARAMS) {
  chunk_merge_body(acc, m, l, start, end, out, hkv, g, hd, cap, n_chunks);
}

// Launch a merge over ``rows`` (lane, kv head, query head) rows as a programmatic
// dependent of the kernel before it on the stream: its blocks are made resident
// while that kernel runs and wait on the card for its writes.
int launch_merge(bool paged, const float* acc, const float* m, const float* l,
                 const int* start, const int* end, float* out, int rows, int hkv, int g,
                 int hd, int cap, int n_chunks, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3((hd + 31) / 32 * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, paged ? paged_decode_merge_kernel : contig_decode_merge_kernel,
                         acc, m, l, start, end, out, hkv, g, hd, cap, n_chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A 2-D bf16 tensor map over rows of ``inner`` elements, ``row_bytes`` apart, read in
// boxes of (box_inner, box_rows); ``cuTensorMapEncodeTiled`` is found through the
// runtime, so the library needs no -lcuda. Out-of-range elements read as zeros.
bool encode_2d(CUtensorMap* map, const void* base, int64_t inner, int64_t rows,
               int64_t row_bytes, int box_inner, int box_rows, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The single pass (n_splits 0: ``out`` normalized, chunk partials in ``ws`` where
// the span is over one chunk) or B2 stage 1 (``ws`` takes the split partials).
template <typename TQ, typename TKV, int kG, int kDC, int kWarps, bool kPaged, bool kSplit>
int launch_chunked(const void* q, const void* kc, const void* vc, const void* table,
                   const void* start, const void* end, void* out, void* ws, int batch, int hkv,
                   int lane_heads, int g, int hd, int bsz, int nb, int n_pages, int bps,
                   int n_splits, float scale, float softcap, int has_cap, cudaStream_t s) {
  ChunkGeom geo = {};
  geo.hkv = hkv;
  geo.lane_heads = lane_heads;
  geo.g = g;
  geo.hd = hd;
  geo.bsz = bsz;
  geo.nb = nb;
  const int cap = nb * bsz;
  geo.n_chunks = kSplit ? n_splits : (cap + kChunk - 1) / kChunk;
  geo.span = kSplit ? bps * bsz : kChunk;
  if ((kSplit || geo.n_chunks > 1) && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  geo.scale = scale;
  geo.softcap = softcap;
  geo.has_cap = has_cap;
  constexpr int esz = static_cast<int>(sizeof(TKV));
  constexpr bool kBf16 =
      std::is_same<TQ, __nv_bfloat16>::value && std::is_same<TKV, __nv_bfloat16>::value;
  // the copy engine needs 16-byte aligned runs
  const bool aligned = reinterpret_cast<uintptr_t>(kc) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(vc) % 16 == 0 && hd * esz % 16 == 0;
  const bool one_page = !kPaged || bsz % kTile == 0;     // a tile lies in one page or lane
  CUtensorMap tmk = {}, tmv = {};
  // (boxes no wider than the tensor: hd >= 64, and a lane of at least one tile)
  if (kBf16 && kDC == 4 && hd % 16 == 0 && hd >= 64 && aligned && bsz * esz % 16 == 0 &&
      ((one_page && bsz >= kTile) || bsz == 8 || bsz == 16)) {
    geo.tma = 1;
    geo.pw = one_page ? kTile : bsz;
    geo.kps = hd * bsz + 16 / esz;
    geo.n_vcb = (hd + 63) / 64;
    geo.kt_bytes = round_up(one_page ? hd * 64 : kTile / bsz * geo.kps * esz, 1024);
    geo.stage_bytes = geo.kt_bytes + geo.n_vcb * kTile * 128;
    // head rows from the first head read to the last: a window's lanes are lane_heads apart
    const int64_t lanes = (static_cast<int64_t>(kPaged ? n_pages : batch) - 1) * lane_heads + hkv;
    if ((one_page && !encode_2d(&tmk, kc, bsz, lanes * hd, bsz * esz, kTile, hd,
                                CU_TENSOR_MAP_SWIZZLE_64B)) ||
        !encode_2d(&tmv, vc, hd, lanes * bsz, hd * esz, 64, geo.pw, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorNotSupported);
  } else {
    geo.pw = kTile;
    geo.kt_bytes = round_up(hd * kTile * esz, 128);
    geo.stage_bytes = geo.kt_bytes + round_up(kTile * hd * esz, 128);
    geo.q_bytes = round_up((hd + 7) / 8 * 8 * kG * 4, 128);
  }
  while ((1 << geo.pw_log2) < geo.pw) ++geo.pw_log2;
  // two stages per warp where two such blocks still fit on one SM, else one;
  // 1024 bytes of slack align the stages
  const int fixed = 1024 + round_up(kBarBytes + geo.q_bytes, 1024);
  const int two = fixed + kWarps * 2 * geo.stage_bytes;
  geo.stages = 2 * (two + kBlockReserve) <= kSmPerSm ? 2 : 1;
  const int smem = fixed + kWarps * geo.stages * geo.stage_bytes;
  if (smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);

  auto kern = paged_decode_kernel<TQ, TKV, kG, kDC, kWarps, kSplit>;
  if constexpr (!kPaged) kern = contig_decode_kernel<TQ, TKV, kG, kDC, kWarps>;
  static int smem_set = 0;   // per instantiation: raise the opt-in limit once
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  kern<<<dim3(geo.n_chunks, batch * hkv), kWarps * 32, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
      static_cast<const int*>(table), static_cast<const int*>(start),
      static_cast<const int*>(end), static_cast<float*>(out), static_cast<float*>(ws), geo, tmk,
      tmv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kSplit || geo.n_chunks == 1) return static_cast<int>(err);
  // the chunks' merge, launched while the chunk kernel runs
  const float* acc = static_cast<const float*>(ws);
  const int64_t n_parts = static_cast<int64_t>(batch) * hkv * geo.n_chunks;
  return launch_merge(kPaged, acc, acc + n_parts * g * hd, acc + n_parts * g * (hd + 1),
                      static_cast<const int*>(start), static_cast<const int*>(end),
                      static_cast<float*>(out), batch * hkv * g, hkv, g, hd, cap, geo.n_chunks,
                      s);
}

template <typename TQ, typename TKV, bool kPaged, bool kSplit>
int launch_chunked_shaped(const void* q, const void* kc, const void* vc, const void* table,
                          const void* start, const void* end, void* out, void* ws, int batch,
                          int hkv, int lane_heads, int g, int hd, int bsz, int nb, int n_pages,
                          int bps, int n_splits, float scale, float softcap, int has_cap,
                          cudaStream_t s) {
#define REPRO_SHAPE(KG, KDC, KW)                                                            \
  return launch_chunked<TQ, TKV, KG, KDC, KW, kPaged, kSplit>(                             \
      q, kc, vc, table, start, end, out, ws, batch, hkv, lane_heads, g, hd, bsz, nb,       \
      n_pages, bps, n_splits, scale, softcap, has_cap, s)
  // a split walks more tiles than a chunk: eight warps a block where K/V are bf16
  // (eight warps' f32 stages do not fit a block's shared memory)
  constexpr int kNarrowWarps = kSplit && std::is_same<TKV, __nv_bfloat16>::value ? 8 : 4;
  if (g == 1 && hd <= 128) REPRO_SHAPE(1, 4, kNarrowWarps);
  if (g <= 4 && hd <= 128) REPRO_SHAPE(4, 4, kNarrowWarps);
  REPRO_SHAPE(16, 8, 2);
#undef REPRO_SHAPE
}

// K/V element type codes of the C entry points (the wrapper's ``_KV_CODES``)
constexpr int kKvBf16 = 0, kKvF32 = 1, kKvFp8 = 2;

template <bool kPaged, bool kSplit>
int launch_typed(const void* q, const void* kc, const void* vc, const void* table,
                 const void* start, const void* end, void* out, void* ws, int batch, int hkv,
                 int lane_heads, int g, int hd, int bsz, int nb, int n_pages, int bps,
                 int n_splits, float scale, float softcap, int has_cap, int q_f32, int kv_dtype,
                 void* stream) {
  if (hd < 1 || hd > 256 || g < 1 || g > 16 || bsz < 1 || nb < 1 || lane_heads < hkv ||
      (kSplit && (bps < 1 || n_splits < 1 || (n_splits - 1) * bps >= nb)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                                \
  return launch_chunked_shaped<TQ, TKV, kPaged, kSplit>(q, kc, vc, table, start, end, out,  \
                                                        ws, batch, hkv, lane_heads, g, hd,  \
                                                        bsz, nb, n_pages, bps, n_splits,    \
                                                        scale, softcap, has_cap, s)
  if (kv_dtype == kKvF32 && q_f32) REPRO_LAUNCH(float, float);
  if (kv_dtype == kKvF32) REPRO_LAUNCH(__nv_bfloat16, float);
  if (kv_dtype == kKvFp8 && q_f32) REPRO_LAUNCH(float, __nv_fp8_e4m3);
  if (kv_dtype == kKvFp8) REPRO_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3);
  if (kv_dtype != kKvBf16) return static_cast<int>(cudaErrorInvalidValue);
  if (q_f32) REPRO_LAUNCH(float, __nv_bfloat16);
  REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
}

}  // namespace

// Tokens of one chunk of the single pass: the wrapper sizes the partials of a
// launch, (B * Hkv * ceil(NB * Bsz / chunk)) x G x (hd + 2) floats, from it.
extern "C" int decode_chunk_tokens(void) { return kChunk; }

// B1: single pass, normalized f32 output (B, Hkv, G, hd). ``ws`` holds the chunk
// partials when the table spans more than one chunk (else it may be null).
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* table, const void* start, const void* end,
                                   void* out, void* ws, int batch, int hkv, int g, int hd,
                                   int bsz, int nb, int n_pages, float scale, float softcap,
                                   int has_cap, int q_f32, int kv_dtype, void* stream) {
  return launch_typed<true, false>(q, kp, vp, table, start, end, out, ws, batch, hkv, hkv, g,
                                   hd, bsz, nb, n_pages, 0, 0, scale, softcap, has_cap, q_f32,
                                   kv_dtype, stream);
}

// B2 stage 1 over n_splits splits of bps blocks (the caller applies the realized-split
// rule): the unnormalized partials in one buffer ``parts``, acc (B, Hkv, S, G, hd),
// then m and l (B, Hkv, S, G); a dead split holds the identity partial.
extern "C" int paged_split_launch(const void* q, const void* kp, const void* vp,
                                  const void* table, const void* start, const void* end,
                                  void* parts, int batch, int hkv, int g, int hd, int bsz, int nb,
                                  int n_pages, int bps, int n_splits, float scale, float softcap,
                                  int has_cap, int q_f32, int kv_dtype, void* stream) {
  return launch_typed<true, true>(q, kp, vp, table, start, end, nullptr, parts, batch, hkv,
                                  hkv, g, hd, bsz, nb, n_pages, bps, n_splits, scale, softcap,
                                  has_cap, q_f32, kv_dtype, stream);
}

// B4: single pass over contiguous lanes, K (B, Hkv, hd, Lmax) and V (B, Hkv, Lmax, hd);
// normalized f32 output (B, Hkv, G, hd). The lane is its own page of Lmax tokens;
// ``ws`` as for B1, with Lmax in place of the table's span. ``k`` and ``v`` may be a
// window of Hkv heads of lanes that hold ``lane_heads`` >= Hkv heads (the view
// ``k[:, j0:j1]`` of a (B, lane_heads, hd, Lmax) cache, read in place); lane_heads ==
// Hkv is a whole cache.
extern "C" int contig_decode_launch(const void* q, const void* k, const void* v,
                                    const void* start, const void* end, void* out, void* ws,
                                    int batch, int hkv, int g, int hd, int lmax, int lane_heads,
                                    float scale, float softcap, int has_cap, int q_f32,
                                    int kv_dtype, void* stream) {
  return launch_typed<false, false>(q, k, v, nullptr, start, end, out, ws, batch, hkv,
                                    lane_heads, g, hd, lmax, 1, batch, 0, 0, scale, softcap,
                                    has_cap, q_f32, kv_dtype, stream);
}

// B2 stage 2: any (B, Hkv, S, G) partials merged into the normalized f32 output
// (B, Hkv, G, hd), launched as a programmatic dependent of the kernel before it.
extern "C" int merge_splits_launch(const void* acc, const void* m, const void* l, void* out,
                                   int batch, int hkv, int n_splits, int g, int hd,
                                   void* stream) {
  if (hd < 1 || hd > 1024 || g < 1 || n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_merge(true, static_cast<const float*>(acc), static_cast<const float*>(m),
                      static_cast<const float*>(l), nullptr, nullptr, static_cast<float*>(out),
                      batch * hkv * g, hkv, g, hd, 0, n_splits,
                      static_cast<cudaStream_t>(stream));
}
