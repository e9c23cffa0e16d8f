// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `ssd_scan` (src/repro/kernels/ssd_scan/ssd_scan.py:63,
// `pallas_call` at :75, body `_ssd_kernel` :20). Per (lane b, head h) a (P, N) f32
// state S is carried along T. Inside a chunk, with al the cumulative log decay,
//   y[t] = sum_{s<=t} (c_t . b_s) exp(al_t - al_s) x[s] + exp(al_t) S c_t,
//   S'   = exp(al_last) S + sum_s exp(al_last - al_s) x[s] (x) b[s].
//
// Bound on the H100: the bytes. x in and y out (B T H P f32 each), a, b, c, s0 and
// the final state: 492 MB at B 4, T 2048, H 112, P = N = 64, 0.147 ms at 3.35 TB/s.
// The chunked products at this kernel's sub-chunk of 32 (the scores once per lane,
// the masked intra-chunk product, the carried-state product and the state update
// per head) are 17.0 GFLOP, 51 GFLOP as three TF32 products, 0.103 ms at the
// tensor cores' 495 TFLOP/s: under the bytes.
//
// What held the earlier kernel (9.9 ms) back, and what this design does about it:
//   * Every multiply-add read two shared-memory operands on the CUDA cores. Here the
//     four chunked products run on the tensor cores (mma.sync m16n8k8 TF32, f32
//     accumulators). One TF32 product keeps 11 bits of each operand, about 5e-4
//     relative, outside the f32 tolerance, so each operand is split into two TF32
//     pieces, hi = v rounded to nearest and lo = v - hi, and each product is lo*hi +
//     hi*lo + hi*hi: about 21 bits, the plain version's f32 result within rtol = atol
//     = 1e-4. The rounding is two integer instructions: sm_90 has no single
//     instruction for cvt.rna.tf32.f32, whose emulation made the splits dearer than
//     the products they feed.
//   * The scores C B^T depend on (lane, sub-chunk) only, yet were recomputed for
//     each of the H heads. Here a first small kernel computes them once per (lane,
//     sub-chunk) into a scratch tensor (B, ceil(T/32), 32, 32), zero above the
//     diagonal, which stays in L2; each head applies its own decay mask.
//   * The work grew with the chunk: Q^2 (N + P) / 2 of the 256-step chunk's
//     intra-chunk products. The walk here takes sub-chunks of kQ = 32 steps whatever
//     the caller's chunk (the op pads T to it with zero-decay steps; the result does
//     not depend on the chunking beyond rounding), which also keeps each cumulative
//     log decay to a span of 32 steps.
//   * 448 blocks of 8 warps with 193 KB of shared memory each ran one to an SM, in
//     3.4 waves. Here a block of 2 warps carries 64 rows of one head's state (grid:
//     H * ceil(P / 64) by B) with 56 KB of shared memory, so four fit an SM: the 448
//     walks of zamba2's scan at B 4 are all resident at once (in 85 % of the 528
//     slots).
//   * The state lives in registers for the whole walk: warp w holds rows [32w,
//     32w + 32) of the (64, N) slice as two 16-row tiles of mma accumulators, updated
//     in place, and the same registers are the A operand of the carried-state product
//     S C^T (an accumulator's columns 2q and 2q + 1 stand for the A fragment's k slots
//     q and q + 4; the B operand reads c with the same permutation, as one float2).
//     Two tiles a warp, not one: each B fragment is then loaded and split once for two
//     products (four warps of one tile each split every B operand four times over and
//     spilled at 128 registers: slower, PERF.md).
//   * Loads ran behind the arithmetic. Here a sub-chunk's x (32 x 64), b and c (32 x
//     N) and scores (32 x 32) are copied with cp.async into the other of two shared-
//     memory stages while the current one computes, and its decays a sub-chunk ahead
//     into a register. The cumulative decay is a warp scan (__shfl_up_sync, one step
//     a lane), not a block-wide scan with a barrier a round. Each exp(al_t - al_s) is
//     computed once per element of the (32, 32) score tile by one thread, in place,
//     before the products; the exponent is clamped to 0, so the mask never
//     overflows (s <= t gives at most 1; above the diagonal the scores are zero).
//   * Rows of 64 floats sit in shared memory with their 16-byte chunks swizzled (chunk
//     c of row r at c ^ ((r & 3) << 1); of a 32-float score row at c ^ (r & 7)), so
//     every fragment load hits 32 distinct banks without padding.
//   * A lane's result depends on its own inputs only (a block per (sub-chunk, lane)
//     and per (head, lane) in a fixed order, no atomics): a lane scanned alone gives
//     the same bits as inside a batch.
//
// What bounds it now is the issue of mma.sync and of the arithmetic feeding it (the
// operand splits are the largest part of the walk's instructions), not the bytes:
// mma.sync does not reach the TF32 rate above, which only wgmma does (PERF.md).
//
// Any N: a walk block carries 64 state columns in registers, so N over 64 takes
// ceil(N / 64) column tiles, each a block of its own. The state update is per column
// and the carried-state product S c_t splits into the tiles' sums, so tile j > 0
// writes its share of y into a scratch slab and a third small kernel adds the slabs
// into y in a fixed order (no atomics: the bits do not depend on the schedule); the
// masked intra-chunk product is added once, by tile 0. The scores kernel reduces
// over N in 64-wide tiles. zamba2's N = 64 is one tile and takes none of this.
// Any P (slices of 64), T and chunk (T a multiple of the chunk, as in the JAX kernel). Rows past T and
// columns past P or N are zeros in shared memory and are never stored. P and N
// multiples of 4 with 16-byte aligned x, b, c and y take 16-byte copies, other shapes
// 4-byte ones; y is written in 16-byte rows where P is a multiple of 4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;                 // steps of a sub-chunk: one lane each in the scan
constexpr int kThreads = 128;          // the scores kernel: a warp per 8 score columns
constexpr int kPT = 64;                // state rows (of P) one walk block carries
constexpr int kNT = 64;                // state columns (N), zero-padded
constexpr int kRowF = 64;              // floats of an x, b or c row in shared memory
constexpr int kTileF = kQ * kRowF;     // one (32, 64) tile
constexpr int kStageF = 3 * kTileF + kQ * kQ;   // x, b, c, scores: 7,168 floats
constexpr int kSmemBytes = 2 * kStageF * 4;     // two stages: 57,344 bytes, four blocks an SM
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPT == kRowF && kNT == kRowF, "x, b and c tiles share one row width");

// Swizzled positions: 16-byte chunk c of a 64-float row r at c ^ ((r & 3) << 1),
// of a 32-float score row r at c ^ (r & 7).
__device__ __forceinline__ int sw_row(int r, int col) {
  return r * kRowF + (((col >> 2) ^ ((r & 3) << 1)) << 2) + (col & 3);
}
__device__ __forceinline__ int sw_g(int r, int col) {
  return r * kQ + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; an invalid source fills zeros and reads nothing
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// Rows [0, rows) of a slab whose row r starts at base + r * stride, columns [0,
// width), into a swizzled (kQ, 64) tile; the rest of the tile is zeros.
template <bool kVec, int kT>
__device__ __forceinline__ void load_rows(float* tile, const float* base, int64_t stride,
                                          int rows, int width) {
  if (kVec) {
    for (int e = threadIdx.x; e < kTileF / 4; e += kT) {
      const int r = e >> 4, col = (e & 15) << 2;
      const bool ok = r < rows && col < width;
      cp16(tile + sw_row(r, col), ok ? base + r * stride + col : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTileF; e += kT) {
      const int r = e >> 6, col = e & 63;
      const bool ok = r < rows && col < width;
      cp4(tile + sw_row(r, col), ok ? base + r * stride + col : base, ok);
    }
  }
}

template <int kT>
__device__ __forceinline__ void load_scores(float* tile, const float* src) {
  for (int e = threadIdx.x; e < kQ * kQ / 4; e += kT) {
    const int r = e >> 3, col = (e & 7) << 2;
    cp16(tile + sw_g(r, col), src + r * kQ + col, true);
  }
}

// ---- three-piece TF32 products -------------------------------------------------

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// v = hi + lo: hi is v rounded to nearest TF32, ties away from zero (what
// cvt.rna.tf32.f32 gives for finite v), and lo = v - hi exactly, whose low 13 bits
// the tensor core ignores: about 21 bits of v in three instructions
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A (16 x 8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// B (8 x 8, column-major): b0 (k q, n g), b1 (k q + 4, n g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d (16 x 8): d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at f32 accuracy: the two small products first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// ---- stage 1: the scores of a (sub-chunk, lane) --------------------------------

// G[t][s] = c_t . b_s for s <= t, zero above the diagonal, into
// scores[lane][sub-chunk] (kQ x kQ, row-major). Warp w computes the score columns
// [8w, 8w + 8) for the 16-row tiles that reach them.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ scores, int t_len, int n) {
  __shared__ __align__(16) float bs[kTileF];
  __shared__ __align__(16) float cs[kTileF];
  const int sub = blockIdx.x, bi = blockIdx.y;
  const int t0 = sub * kQ;
  const int64_t row0 = static_cast<int64_t>(bi) * t_len + t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int col = 8 * warp + g;            // the score column s this lane's B fragment holds
  float acc[2][4] = {};
  for (int n0 = 0; n0 < n; n0 += kNT) {    // N in 64-wide tiles (one at N <= 64)
    if (n0) __syncthreads();               // every warp is done with the last tile
    const int rows = min(kQ, t_len - t0), width = min(kNT, n - n0);
    load_rows<kVec, kThreads>(bs, bm + row0 * n + n0, n, rows, width);
    load_rows<kVec, kThreads>(cs, cm + row0 * n + n0, n, rows, width);
    cp_commit();
    cp_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kNT / 8; ++kk) {
      const int k0 = 8 * kk + q;
      const FragB fb = frag_b(bs[sw_row(col, k0)], bs[sw_row(col, k0 + 4)]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (16 * mt + 15 < 8 * warp) continue;   // rows all above the diagonal
        const int r = 16 * mt + g;
        mma3(acc[mt],
             frag_a(cs[sw_row(r, k0)], cs[sw_row(r + 8, k0)], cs[sw_row(r, k0 + 4)],
                    cs[sw_row(r + 8, k0 + 4)]),
             fb);
      }
    }
  }
  float* out = scores + (static_cast<int64_t>(bi) * gridDim.x + sub) * kQ * kQ;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * mt + g + 8 * (e >> 1), s = 8 * warp + 2 * q + (e & 1);
      out[t * kQ + s] = s <= t ? acc[mt][e] : 0.f;
    }
}

// ---- stage 2: the walk of a (head, 64 state rows, lane) ------------------------

constexpr int kWalkWarps = 2;    // warps of a walk block: two 16-row state tiles each

// Warp w holds the kMT 16-row tiles of state rows [16 kMT w, 16 kMT (w + 1)).
// kSplitN: N over 64, one block per 64-column tile. A separate instantiation keeps
// the tiles' indexing out of the one-tile walk (zamba2's N = 64): one body reading
// the tile at run time took 14 % longer there, at the same register count.
template <bool kVec, bool kSplitN>
__global__ void __launch_bounds__(32 * kWalkWarps, 4)
ssd_walk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ scores, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ y_parts, float* __restrict__ s_out,
                int t_len, int h, int p, int n, int n_pt, int n_nt) {
  constexpr int kW = kWalkWarps, kT = 32 * kW, kMT = kPT / 16 / kW;
  extern __shared__ __align__(16) float smem[];
  const int nt = kSplitN ? blockIdx.x % n_nt : 0;   // column tile
  const int hp = kSplitN ? blockIdx.x / n_nt : blockIdx.x;   // (head, 64 state rows)
  const int hi = hp / n_pt, p0 = (hp - hi * n_pt) * kPT, bi = blockIdx.y;
  const int p_w = min(kPT, p - p0);        // state rows of this slice
  const int n0 = nt * kNT, n_w = kSplitN ? min(kNT, n - n0) : n;   // this tile's columns
  // tile 0 writes y itself (and adds the intra-chunk product); tile j > 0 its slab
  if (kSplitN && nt > 0) y = y_parts + (nt - 1) * (static_cast<int64_t>(gridDim.y) * t_len * h * p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pw = 16 * kMT * warp;          // lane rows: pw + 16 mt + g and + 8
  const int n_sub = (t_len + kQ - 1) / kQ;
  const int64_t row0 = static_cast<int64_t>(bi) * t_len;   // (b, t = 0)
  const int64_t bh = static_cast<int64_t>(bi) * h + hi;

  // The copy plan of a sub-chunk. 16-byte path: thread i copies chunk (i & 15) of
  // rows (i >> 4) + (kT / 16) j of the x, b and c tiles and chunk (i & 7) of score
  // rows (i >> 3) + (kT / 8) j; those rows share their swizzle, so each copy's
  // shared-memory offset is this thread's constant plus an immediate.
  constexpr int kRowStep = kT / 16, kGStep = kT / 8;
  const int cr = threadIdx.x >> 4, cc = (threadIdx.x & 15) << 2;
  const int gr = threadIdx.x >> 3, gc = (threadIdx.x & 7) << 2;
  const int off_row = sw_row(cr, cc), off_g = sw_g(gr, gc);
  const bool x_col = cc < p_w, n_col = cc < n_w;
  const int64_t x_step = static_cast<int64_t>(h) * p;   // floats from one step to the next
  const float* x_src = x + ((row0 + cr) * h + hi) * p + p0 + cc;
  const float* b_src = bm + (row0 + cr) * n + n0 + cc;
  const float* c_src = cm + (row0 + cr) * n + n0 + cc;
  const float* g_src = scores + static_cast<int64_t>(bi) * n_sub * kQ * kQ + gr * kQ + gc;
  auto issue = [&](int sub) {              // the sub-chunk's x, b, c and scores
    float* st = smem + (sub & 1) * kStageF;
    const int t0 = sub * kQ;
    if (kVec) {
#pragma unroll
      for (int j = 0; j < kQ / kRowStep; ++j) {
        const int t = t0 + kRowStep * j;
        const bool live = t + cr < t_len;
        const int off = off_row + j * kRowStep * kRowF;
        cp16(st + off, live && x_col ? x_src + t * x_step : x, live && x_col);
        cp16(st + kTileF + off, live && n_col ? b_src + static_cast<int64_t>(t) * n : bm,
             live && n_col);
        cp16(st + 2 * kTileF + off, live && n_col ? c_src + static_cast<int64_t>(t) * n : cm,
             live && n_col);
      }
#pragma unroll
      for (int j = 0; j < kQ / kGStep; ++j)
        cp16(st + 3 * kTileF + off_g + j * kGStep * kQ,
             g_src + (sub * kQ + kGStep * j) * kQ, true);
    } else {
      const int64_t r = row0 + t0;
      const int rows = min(kQ, t_len - t0);
      load_rows<false, kT>(st, x + (r * h + hi) * p + p0, x_step, rows, p_w);
      load_rows<false, kT>(st + kTileF, bm + r * n + n0, n, rows, n_w);
      load_rows<false, kT>(st + 2 * kTileF, cm + r * n + n0, n, rows, n_w);
      load_scores<kT>(st + 3 * kTileF,
                      scores + (static_cast<int64_t>(bi) * n_sub + sub) * kQ * kQ);
    }
    cp_commit();
  };
  auto load_a = [&](int sub) -> float {    // step sub * kQ + lane's log decay (0 past T)
    const int t = sub * kQ + lane;
    return sub < n_sub && t < t_len ? __ldg(a + (row0 + t) * h + hi) : 0.f;
  };

  // s[mt][jn][e] = S[pw + 16 mt + g + 8 (e >> 1)][8 jn + 2q + (e & 1)]
  float s[kMT][kNT / 8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int jn = 0; jn < kNT / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = pw + 16 * mt + g + 8 * (e >> 1), col = 8 * jn + 2 * q + (e & 1);
        s[mt][jn][e] = r < p_w && col < n_w ? s0[(bh * p + p0 + r) * n + n0 + col] : 0.f;
      }

  issue(0);
  float a_next = load_a(0);
  for (int sub = 0; sub < n_sub; ++sub) {
    float al = a_next;                     // cumulative log decay at step lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, al, off);
      if (lane >= off) al += v;
    }
    a_next = load_a(sub + 1);
    const float al_last = __shfl_sync(kFull, al, kQ - 1);
    const float e_t = expf(al);                // weight of the carried state at t = lane
    const float w_s = expf(al_last - al);      // weight of step s = lane in the next state
    const float decay = expf(al_last);

    cp_wait_all();
    __syncthreads();                           // this stage landed; the other one is free
    if (sub + 1 < n_sub) issue(sub + 1);
    float* xs = smem + (sub & 1) * kStageF;
    const float* bs = xs + kTileF;
    const float* cs = bs + kTileF;
    float* gs = xs + 3 * kTileF;

    // the decay mask, each exp once: warp w takes score columns w, w + kW, ..., row
    // lane. Above the diagonal the scores are zeros and the exponent is clamped to
    // 0 (no branch, and exp of a positive difference could overflow: 0 * inf)
#pragma unroll
    for (int i = 0; i < kQ / kW; ++i) {
      const int col = warp + kW * i;
      const float al_s = __shfl_sync(kFull, al, col);
      gs[sw_g(lane, col)] *= expf(fminf(al - al_s, 0.f));
    }
    __syncthreads();

    // y^T (this warp's state rows x kQ steps): first exp(al_t) S c_t ...
    float yt[kMT][kQ / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNT / 8; ++kk) {
      FragA fs[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        fs[mt] = frag_a(s[mt][kk][0], s[mt][kk][2], s[mt][kk][1], s[mt][kk][3]);
#pragma unroll
      for (int jt = 0; jt < kQ / 8; ++jt) {
        const float2 cv = *reinterpret_cast<const float2*>(cs + sw_row(8 * jt + g, 8 * kk + 2 * q));
        const FragB fb = frag_b(cv.x, cv.y);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(yt[mt][jt], fs[mt], fb);
      }
    }
#pragma unroll
    for (int jt = 0; jt < kQ / 8; ++jt) {
      const float e0 = __shfl_sync(kFull, e_t, 8 * jt + 2 * q);
      const float e1 = __shfl_sync(kFull, e_t, 8 * jt + 2 * q + 1);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        yt[mt][jt][0] *= e0;
        yt[mt][jt][1] *= e1;
        yt[mt][jt][2] *= e0;
        yt[mt][jt][3] *= e1;
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int jn = 0; jn < kNT / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][jn][e] *= decay;

    // ... then the state update, 8 steps s at a time (this lane's steps r0 and
    // r0 + 4), weighted by exp(al_last - al_s) ...
#pragma unroll
    for (int kk = 0; kk < kQ / 8; ++kk) {
      const int r0 = 8 * kk + q;
      const float w0 = __shfl_sync(kFull, w_s, r0), w1 = __shfl_sync(kFull, w_s, r0 + 4);
      FragA fw[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = pw + 16 * mt + g;
        fw[mt] = frag_a(xs[sw_row(r0, r)] * w0, xs[sw_row(r0, r + 8)] * w0,
                        xs[sw_row(r0 + 4, r)] * w1, xs[sw_row(r0 + 4, r + 8)] * w1);
      }
#pragma unroll
      for (int jn = 0; jn < kNT / 8; ++jn) {
        const int col = 8 * jn + g;
        const FragB fb = frag_b(bs[sw_row(r0, col)], bs[sw_row(r0 + 4, col)]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(s[mt][jn], fw[mt], fb);
      }
    }
    // ... and the masked intra-chunk product from the same x (tile 0 only)
    if (!kSplitN || nt == 0) {
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        const int r0 = 8 * kk + q;
        FragA fx[kMT];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r = pw + 16 * mt + g;
          fx[mt] = frag_a(xs[sw_row(r0, r)], xs[sw_row(r0, r + 8)], xs[sw_row(r0 + 4, r)],
                          xs[sw_row(r0 + 4, r + 8)]);
        }
#pragma unroll
        for (int jt = kk; jt < kQ / 8; ++jt) {
          const int t = 8 * jt + g;
          const FragB fb = frag_b(gs[sw_g(t, r0)], gs[sw_g(t, r0 + 4)]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) mma3(yt[mt][jt], fx[mt], fb);
        }
      }
    }

    // y: only this warp reads its state rows' columns of the x tile, so y^T goes
    // there (row t, as y lies in memory) and out as 16-byte rows
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int jt = 0; jt < kQ / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xs[sw_row(8 * jt + 2 * q + (e & 1), pw + 16 * mt + g + 8 * (e >> 1))] = yt[mt][jt][e];
    __syncwarp();
    const int t0 = sub * kQ;
    constexpr int kCols = 16 * kMT;          // this warp's columns of y
    if (kVec) {
      constexpr int kLanesRow = kCols / 4;   // 16-byte chunks of a row
#pragma unroll
      for (int i = 0; i < kQ * kLanesRow / 32; ++i) {
        const int t = i * (32 / kLanesRow) + lane / kLanesRow;
        const int col = pw + 4 * (lane % kLanesRow);
        if (t0 + t < t_len && col < p_w)
          *reinterpret_cast<float4*>(y + ((row0 + t0 + t) * h + hi) * p + p0 + col) =
              *reinterpret_cast<const float4*>(xs + sw_row(t, col));
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kQ * kCols / 32; ++i) {
        const int t = i * (32 / kCols) + lane / kCols, col = pw + lane % kCols;
        if (t0 + t < t_len && col < p_w)
          y[((row0 + t0 + t) * h + hi) * p + p0 + col] = xs[sw_row(t, col)];
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int jn = 0; jn < kNT / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = pw + 16 * mt + g + 8 * (e >> 1), col = 8 * jn + 2 * q + (e & 1);
        if (r < p_w && col < n_w) s_out[(bh * p + p0 + r) * n + n0 + col] = s[mt][jn][e];
      }
}

// y += the column tiles' slabs, in tile order (N over 64 only)
__global__ void ssd_sum_parts_kernel(float* __restrict__ y, const float* __restrict__ parts,
                                     int64_t elems, int n_parts) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < elems;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = y[i];
    for (int j = 0; j < n_parts; ++j) v += parts[j * elems + i];
    y[i] = v;
  }
}

template <bool kVec, bool kSplitN>
int launch_walk(const float* x, const float* a, const float* b, const float* c,
                const float* scores, const float* s0, float* y, float* y_parts, float* s_out,
                int batch, int t_len, int h, int p, int n, cudaStream_t stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(ssd_walk_kernel<kVec, kSplitN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_walk_kernel<kVec, kSplitN>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs_set = true;
  }
  const int n_pt = (p + kPT - 1) / kPT;
  const int n_nt = (n + kNT - 1) / kNT;
  ssd_walk_kernel<kVec, kSplitN><<<dim3(h * n_pt * n_nt, batch), 32 * kWalkWarps, kSmemBytes,
                                   stream>>>(x, a, b, c, scores, s0, y, y_parts, s_out, t_len,
                                             h, p, n, n_pt, n_nt);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch(const float* x, const float* a, const float* b, const float* c, const float* s0,
           float* y, float* y_parts, float* s_out, float* scores, int batch, int t_len,
           int h, int p, int n, cudaStream_t stream) {
  const int n_sub = (t_len + kQ - 1) / kQ;
  const int n_nt = (n + kNT - 1) / kNT;
  ssd_scores_kernel<kVec><<<dim3(n_sub, batch), kThreads, 0, stream>>>(b, c, scores, t_len, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nt == 1)
    return launch_walk<kVec, false>(x, a, b, c, scores, s0, y, y_parts, s_out, batch, t_len, h,
                                    p, n, stream);
  const int werr = launch_walk<kVec, true>(x, a, b, c, scores, s0, y, y_parts, s_out, batch,
                                           t_len, h, p, n, stream);
  if (werr != 0) return werr;
  const int64_t elems = static_cast<int64_t>(batch) * t_len * h * p;
  const int64_t want = (elems + 255) / 256;
  ssd_sum_parts_kernel<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, stream>>>(
      y, y_parts, elems, n_nt - 1);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// x (B, T, H, P), a (B, T, H), b and c (B, T, N), s0 (B, H, P, N), all f32 ->
// y (B, T, H, P) f32 and s_out (B, H, P, N) f32. scores is f32 scratch of
// B * ceil(T / 32) * 32 * 32 floats, 16-byte aligned; y_parts, for N > 64, is f32
// scratch of (ceil(N / 64) - 1) * B * T * H * P floats (may be null at N <= 64).
// T must be a multiple of q (the caller's chunk, which the op pads to); the kernels
// walk sub-chunks of 32 whatever q is.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               const void* s0, void* y, void* s_out, void* scores,
                               void* y_parts, int batch, int t_len, int h, int p, int n, int q,
                               void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || h < 1 || p < 1 || n < 1 || q < 1 ||
      t_len % q != 0 ||
      static_cast<int64_t>(h) * ((p + kPT - 1) / kPT) * ((n + kNT - 1) / kNT) > 0x7fffffff ||
      !aligned16(scores) || (n > kNT && y_parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = p % 4 == 0 && n % 4 == 0 && aligned16(x) && aligned16(b) && aligned16(c) &&
                   aligned16(y) && (y_parts == nullptr || aligned16(y_parts));
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(s_out);
  auto* gf = static_cast<float*>(scores);
  auto* pf = static_cast<float*>(y_parts);
  return vec ? launch<true>(xf, af, bf, cf, sf, yf, pf, of, gf, batch, t_len, h, p, n, st)
             : launch<false>(xf, af, bf, cf, sf, yf, pf, of, gf, batch, t_len, h, p, n, st);
}

// Walk blocks resident on one SM (the occupancy calculator's answer, with this
// launch's shared memory): 4 on the H100 is the design point.
extern "C" int ssd_scan_blocks_per_sm(int vec) {
  int blocks = 0;
  const cudaError_t err =
      vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, ssd_walk_kernel<true, false>, 32 * kWalkWarps, kSmemBytes)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, ssd_walk_kernel<false, false>, 32 * kWalkWarps, kSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
