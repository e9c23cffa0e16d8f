// Flash decode over the CD-PIM dual-layout KV cache, paged or contiguous, for
// Hopper (sm_90a).
//
// Replaces four pieces of the JAX package:
//   * the Pallas kernel `decode_attention_paged`
//     (src/repro/kernels/decode_attention/decode_attention.py:165; body `_paged_kernel`
//     :153 -> `_decode_attn_kernel` :46): single-pass online-softmax decode;
//   * the Pallas kernel `decode_attention_paged_split` (:309; `_split_kernel` :244,
//     `_clamp_split` :296): stage 1 of the split-KV reduction, one unnormalized
//     (acc, m, l) partial per split;
//   * `merge_splits` (src/repro/kernels/decode_attention/ref.py:72), stage 2;
//   * the Pallas kernel `decode_attention` (:102, the same `_decode_attn_kernel` body):
//     single-pass decode over contiguous lanes, K (B, Hkv, hd, Lmax) column-wise and
//     V (B, Hkv, Lmax, hd) row-wise, as the contiguous CachePool and the hybrid
//     (zamba2) shared block hold them.
//
// Bound on the H100: the live K/V bytes. Every live cache element is read once and
// used for G (=4 for llama3-8b) multiply-adds in each of the two GEMVs, so the
// kernel is a cache stream at 3.35 TB/s: (end - start) * Hkv * hd * 2 tensors *
// 2 bytes per lane and layer.
//
// Design:
//   * A decode batch has few (lane, kv head) pairs: 32 at B = 4 for llama3-8b,
//     against 132 SMs. So each (lane, kv head[, split]) is walked by a thread-block
//     cluster of C <= 8 blocks (Hopper clusters), C chosen from the tokens one
//     block-table row can hold, never from the data or the batch, so a lane's
//     result depends on its own inputs only.
//   * Inside the cluster every warp walks its own 32-token tiles of the live range
//     [start, end) (intersected with the split's block range) and keeps its own
//     online-softmax state (m, l, acc) for the G query heads of the group in
//     registers: no block barrier inside the token walk. Each token's physical page
//     id is read from the block table itself, so dead pages are never visited and
//     cache traffic scales with the fill. This replaces the TPU kernel's sequential
//     grid with its `_clamp_tile` revisit trick (:93).
//   * The paper's section III-C mapping pays off on the GPU as it does on the PIM
//     banks. A K page is column-wise (hd, Bsz): in the score GEMV each lane owns a
//     token, and for a fixed d the lanes of one page read neighbouring addresses
//     (the outer-product flow). A V page is row-wise (Bsz, hd): in the output GEMV
//     each lane owns d, and for a fixed token the warp reads one contiguous row
//     (the inner-product flow).
//   * The partials merge in a fixed order: the warps of a block through shared
//     memory, then the blocks of the cluster through distributed shared memory
//     into block rank 0, which writes the result. No atomics, so the kernel is
//     deterministic.
//   * Online softmax in f32 with the finite NEG_INF = -2.3819763e38 of the JAX
//     package. An empty range (end <= start) gives exact zeros through the l > 0
//     guard (:89). A dead split writes the identity partial (m = NEG_INF, l = 0,
//     acc = 0), and the merge of an all-dead lane gives zeros, not NaN, because
//     exp(NEG_INF - NEG_INF) = exp(0) = 1 is multiplied by l = 0.
//   * The split axis is grid.z, each split with a cluster of its own. The
//     realized-split rule bps = ceil(NB/S), S_real = ceil(NB/bps) (:336-337) is
//     applied by the caller.
//   * Contiguous lanes (kPaged = false, entry contig_decode_kernel) take the
//     same body with lane strides in place of the block table: token t of lane
//     b sits at column t of lane b's K (stride Lmax between d rows) and row t
//     of its V, i.e. one "page" of Lmax tokens whose id is the lane itself. No
//     table is read.
// Limits: hd <= 256, G <= 16, any page size Bsz or Lmax. With hd <= 128, G == 1
// (zamba2: hd 112) and G <= 4 (llama3-8b) take narrow instantiations with 8
// warps per block, the rest a wide one with 4. The G == 1 one holds a quarter
// of the G <= 4 one's softmax state (48 registers against 80), so more blocks
// stay resident: at zamba2's shape the kernel took 0.070 ms with it and
// 0.108 ms without (chip_smoke.py, two runs on an H100). A query head beyond G
// holds zeros and is never stored; a d-lane beyond hd (hd 112: lanes 16-31 of
// the fourth 32-wide chunk) loads nothing and stores nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kMaxCluster = 8;   // portable cluster size limit
constexpr int kKUnroll = 16;     // K loads each lane issues before its FMAs

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Shared memory, in floats, of one block of the instantiation <kG, kWarps>.
inline size_t smem_floats(int kG, int kWarps, int hd) {
  const int hdp = (hd + kKUnroll - 1) / kKUnroll * kKUnroll;
  return static_cast<size_t>(hdp) * kG          // q, d-major, zero-padded
         + static_cast<size_t>(kWarps) * kG * hd  // per-warp acc
         + 2 * kWarps * kG                        // per-warp m, l
         + static_cast<size_t>(kG) * hd           // block acc
         + 2 * kG;                                // block m, l
}

#define REPRO_DECODE_PARAMS                                                                \
  const TQ* __restrict__ q, const TKV* __restrict__ k_pages,                               \
      const TKV* __restrict__ v_pages, const int* __restrict__ table,                      \
      const int* __restrict__ start, const int* __restrict__ end, float* __restrict__ out, \
      float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out,   \
      int hkv, int g, int hd, int bsz, int nb, int bps, float scale, float softcap,        \
      int has_cap
#define REPRO_DECODE_ARGS                                                                  \
  q, k_pages, v_pages, table, start, end, out, acc_out, m_out, l_out, hkv, g, hd, bsz, nb, \
      bps, scale, softcap, has_cap

// The body every decode-attention kernel runs. kG: query heads per kv head
// held in registers (>= G); kDC: 32-wide d chunks per lane (>= hd / 32);
// kFinal: normalized output (single pass) or partials; kPaged: pages through a
// block table, or contiguous lanes.
template <typename TQ, typename TKV, int kG, int kDC, int kWarps, bool kFinal, bool kPaged>
__device__ __forceinline__ void decode_body(REPRO_DECODE_PARAMS) {
  constexpr int kPV = kDC <= 4 ? 4 : 2;   // tokens whose V rows are loaded together
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float smem[];
  const int hdp = (hd + kKUnroll - 1) / kKUnroll * kKUnroll;
  float* qs = smem;                       // (hdp, kG)
  float* wacc = qs + hdp * kG;            // (kWarps, kG, hd)
  float* wm = wacc + kWarps * kG * hd;    // (kWarps, kG)
  float* wl = wm + kWarps * kG;           // (kWarps, kG)
  float* bacc = wl + kWarps * kG;         // (kG, hd)   this block's merged partial
  float* bm = bacc + kG * hd;             // (kG,)
  float* bl = bm + kG;                    // (kG,)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int bh_i = blockIdx.y;            // b * Hkv + h
  const int b = bh_i / hkv;
  const int h = bh_i - b * hkv;
  const int si = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = bh_i;

  // live tokens of this (lane, split)
  const int lo = max(start[b], si * bps * bsz);
  const int hi = min(end[b], min((si + 1) * bps, nb) * bsz);

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
    for (int c = 0; c < kDC; ++c) acc[gi][c] = 0.f;
  }

  const int vwarp = rank * kWarps + warp;          // this warp's place in the cluster
  const int n_vwarps = n_ranks * kWarps;
  for (int tok0 = lo + vwarp * 32; tok0 < hi; tok0 += n_vwarps * 32) {
    const int tok = tok0 + lane;
    const bool valid = tok < hi;
    int64_t kb = 0, vb = 0;
    if (valid) {
      // paged: the block table names the page; contiguous: the lane is the page
      const int64_t page = kPaged ? table[static_cast<int64_t>(b) * nb + tok / bsz] : b;
      const int off = kPaged ? tok % bsz : tok;
      kb = ((page * hkv + h) * hd) * bsz + off;    // K[page, h, 0, off]
      vb = ((page * hkv + h) * bsz + off) * hd;    // V[page, h, off, 0]
    }
    // score GEMV, outer-product flow: this lane's token against the G queries
    float s[kG];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) s[gi] = 0.f;
    if (valid) {
      const TKV* kcol = k_pages + kb;
      for (int d0 = 0; d0 < hd; d0 += kKUnroll) {
        float kr[kKUnroll];
#pragma unroll
        for (int u = 0; u < kKUnroll; ++u)
          kr[u] = d0 + u < hd ? to_f(kcol[static_cast<int64_t>(d0 + u) * bsz]) : 0.f;
#pragma unroll
        for (int u = 0; u < kKUnroll; ++u) {
          const float* qd = qs + (d0 + u) * kG;
#pragma unroll
          for (int gi = 0; gi < kG; ++gi) s[gi] += qd[gi] * kr[u];
        }
      }
    }
    // online-softmax update; m and l are the same in every lane of the warp
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      float x = s[gi] * scale;
      if (has_cap) x = softcap * tanhf(x / softcap);
      x = valid ? x : kNegInf;
      const float m_new = fmaxf(m[gi], warp_max(x));
      const float p = valid ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[gi] - m_new);
      l[gi] = l[gi] * alpha + warp_sum(p);
      m[gi] = m_new;
      s[gi] = p;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[gi][c] *= alpha;
    }
    // output GEMV, inner-product flow: lane d walks the tile's V rows
    const int n_valid = min(32, hi - tok0);
    for (int t0 = 0; t0 < n_valid; t0 += kPV) {
      float vr[kPV][kDC];
#pragma unroll
      for (int u = 0; u < kPV; ++u) {
        const int t = t0 + u;
        const int64_t vrow = __shfl_sync(kFull, static_cast<long long>(vb), t & 31);
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const int d = lane + 32 * c;
          vr[u][c] = (t < n_valid && d < hd) ? to_f(v_pages[vrow + d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kPV; ++u) {
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) {
          const float p = __shfl_sync(kFull, s[gi], (t0 + u) & 31);
#pragma unroll
          for (int c = 0; c < kDC; ++c) acc[gi][c] += p * vr[u][c];
        }
      }
    }
  }

  // merge 1: the warps of this block, in warp order
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    if (lane == 0) {
      wm[warp * kG + gi] = m[gi];
      wl[warp * kG + gi] = l[gi];
    }
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) wacc[(warp * kG + gi) * hd + d] = acc[gi][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kWarps * 32) {
    const int gi = i / hd, d = i - gi * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kG + gi]);
    float lt = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(wm[w * kG + gi] - mx);
      lt += wl[w * kG + gi] * a;
      o += wacc[(w * kG + gi) * hd + d] * a;
    }
    bacc[gi * hd + d] = o;
    if (d == 0) {
      bm[gi] = mx;
      bl[gi] = lt;
    }
  }
  cluster.sync();   // every block's partial is in its shared memory

  // merge 2: the blocks of the cluster, in rank order, read by rank 0
  if (rank == 0) {
    for (int i = tid; i < g * hd; i += kWarps * 32) {
      const int gi = i / hd;
      float mx = kNegInf;
      for (int r = 0; r < n_ranks; ++r) mx = fmaxf(mx, cluster.map_shared_rank(bm, r)[gi]);
      float lt = 0.f, o = 0.f;
      for (int r = 0; r < n_ranks; ++r) {
        const float a = expf(cluster.map_shared_rank(bm, r)[gi] - mx);
        lt += cluster.map_shared_rank(bl, r)[gi] * a;
        o += cluster.map_shared_rank(bacc, r)[i] * a;
      }
      if (kFinal) {
        out[bh * g * hd + i] = o / (lt > 0.f ? lt : 1.f);
      } else {
        const int64_t part = bh * n_splits + si;
        acc_out[part * g * hd + i] = o;
        if (i - gi * hd == 0) {
          m_out[part * g + gi] = mx;
          l_out[part * g + gi] = lt;
        }
      }
    }
  }
  cluster.sync();   // keep every block's shared memory alive until rank 0 has read it
}

// B1 and B2 stage 1: pages through a block table.
template <typename TQ, typename TKV, int kG, int kDC, int kWarps, bool kFinal>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(REPRO_DECODE_PARAMS) {
  decode_body<TQ, TKV, kG, kDC, kWarps, kFinal, true>(REPRO_DECODE_ARGS);
}

// B4: contiguous lanes (``table`` is not read). A kernel of its own name, so a
// profile tells it from the paged one.
template <typename TQ, typename TKV, int kG, int kDC, int kWarps>
__global__ void __launch_bounds__(kWarps * 32) contig_decode_kernel(REPRO_DECODE_PARAMS) {
  decode_body<TQ, TKV, kG, kDC, kWarps, true, false>(REPRO_DECODE_ARGS);
}

// Stage 2: associative merge of per-split partials. One block per (lane, head,
// query head), one thread per d.
__global__ void merge_splits_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                    const float* __restrict__ l, float* __restrict__ out,
                                    int n_splits, int g, int hd) {
  const int row = blockIdx.x;            // (b * Hkv + h) * G + gi
  const int gi = row % g;
  const int64_t bh = row / g;
  const int d = threadIdx.x;
  float m_max = kNegInf;
  for (int s = 0; s < n_splits; ++s) m_max = fmaxf(m_max, m[(bh * n_splits + s) * g + gi]);
  float l_tot = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const int64_t part = bh * n_splits + s;
    const float alpha = expf(m[part * g + gi] - m_max);
    l_tot += l[part * g + gi] * alpha;
    if (d < hd) o += acc[(part * g + gi) * hd + d] * alpha;
  }
  if (d < hd) out[row * static_cast<int64_t>(hd) + d] = o / (l_tot > 0.f ? l_tot : 1.f);
}

template <typename TQ, typename TKV, int kG, int kDC, int kWarps, bool kFinal, bool kPaged>
int launch_typed(const void* q, const void* kp, const void* vp, const void* table,
                 const void* start, const void* end, void* out, void* acc, void* m,
                 void* l, int batch, int hkv, int g, int hd, int bsz, int nb, int bps,
                 int n_splits, float scale, float softcap, int has_cap, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(kG, kWarps, hd);
  static_assert(kFinal || kPaged, "contiguous lanes take the single pass only");
  auto kern = paged_decode_kernel<TQ, TKV, kG, kDC, kWarps, kFinal>;
  if constexpr (!kPaged) kern = contig_decode_kernel<TQ, TKV, kG, kDC, kWarps>;
  static size_t smem_set = 0;   // per instantiation: raise the opt-in limit once
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  // cluster size: enough warps for one 32-token tile each when a block-table
  // row (or split) is full, as a power of two up to the portable limit
  const int tiles = (bps * bsz + 31) / 32;
  int cluster = 1;
  while (cluster < kMaxCluster && cluster * kWarps < tiles) cluster *= 2;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch * hkv, n_splits);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(start), static_cast<const int*>(end), static_cast<float*>(out),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), hkv, g, hd,
      bsz, nb, bps, scale, softcap, has_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool kFinal, bool kPaged>
int launch_shaped(const void* q, const void* kp, const void* vp, const void* table,
                  const void* start, const void* end, void* out, void* acc, void* m, void* l,
                  int batch, int hkv, int g, int hd, int bsz, int nb, int bps, int n_splits,
                  float scale, float softcap, int has_cap, cudaStream_t s) {
#define REPRO_SHAPE(KG, KDC, KW)                                                           \
  return launch_typed<TQ, TKV, KG, KDC, KW, kFinal, kPaged>(                               \
      q, kp, vp, table, start, end, out, acc, m, l, batch, hkv, g, hd, bsz, nb, bps,      \
      n_splits, scale, softcap, has_cap, s)
  if (g == 1 && hd <= 128) REPRO_SHAPE(1, 4, 8);
  if (g <= 4 && hd <= 128) REPRO_SHAPE(4, 4, 8);
  REPRO_SHAPE(16, 8, 4);
#undef REPRO_SHAPE
}

template <bool kFinal, bool kPaged>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* start, const void* end, void* out, void* acc, void* m, void* l,
           int batch, int hkv, int g, int hd, int bsz, int nb, int bps, int n_splits,
           float scale, float softcap, int has_cap, int q_f32, int kv_f32, void* stream) {
  if (hd < 1 || hd > 256 || g < 1 || g > 16 || bsz < 1 || n_splits < 1 || bps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                              \
  return launch_shaped<TQ, TKV, kFinal, kPaged>(q, kp, vp, table, start, end, out, acc, m, \
                                                l, batch, hkv, g, hd, bsz, nb, bps,        \
                                                n_splits, scale, softcap, has_cap, s)
  if (q_f32 && kv_f32) REPRO_LAUNCH(float, float);
  if (q_f32) REPRO_LAUNCH(float, __nv_bfloat16);
  if (kv_f32) REPRO_LAUNCH(__nv_bfloat16, float);
  REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
}

}  // namespace

// B1: single pass, normalized f32 output (B, Hkv, G, hd).
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* table, const void* start, const void* end,
                                   void* out, int batch, int hkv, int g, int hd, int bsz,
                                   int nb, float scale, float softcap, int has_cap, int q_f32,
                                   int kv_f32, void* stream) {
  return launch<true, true>(q, kp, vp, table, start, end, out, nullptr, nullptr, nullptr, batch,
                      hkv, g, hd, bsz, nb, nb, 1, scale, softcap, has_cap, q_f32, kv_f32,
                      stream);
}

// B2 stage 1: unnormalized partials acc (B, Hkv, S, G, hd), m and l (B, Hkv, S, G).
extern "C" int paged_split_launch(const void* q, const void* kp, const void* vp,
                                  const void* table, const void* start, const void* end,
                                  void* acc, void* m, void* l, int batch, int hkv, int g,
                                  int hd, int bsz, int nb, int bps, int n_splits, float scale,
                                  float softcap, int has_cap, int q_f32, int kv_f32,
                                  void* stream) {
  return launch<false, true>(q, kp, vp, table, start, end, nullptr, acc, m, l, batch, hkv, g, hd,
                       bsz, nb, bps, n_splits, scale, softcap, has_cap, q_f32, kv_f32, stream);
}

// B4: single pass over contiguous lanes, K (B, Hkv, hd, Lmax) and V (B, Hkv, Lmax, hd);
// normalized f32 output (B, Hkv, G, hd). The lane is its own page of Lmax tokens.
extern "C" int contig_decode_launch(const void* q, const void* k, const void* v,
                                    const void* start, const void* end, void* out, int batch,
                                    int hkv, int g, int hd, int lmax, float scale,
                                    float softcap, int has_cap, int q_f32, int kv_f32,
                                    void* stream) {
  return launch<true, false>(q, k, v, nullptr, start, end, out, nullptr, nullptr, nullptr,
                             batch, hkv, g, hd, lmax, 1, 1, 1, scale, softcap, has_cap, q_f32,
                             kv_f32, stream);
}

// B2 stage 2: merged, normalized f32 output (B, Hkv, G, hd).
extern "C" int merge_splits_launch(const void* acc, const void* m, const void* l, void* out,
                                   int batch, int hkv, int n_splits, int g, int hd,
                                   void* stream) {
  if (hd < 1 || hd > 1024 || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((hd + 31) / 32) * 32;
  merge_splits_kernel<<<batch * hkv * g, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(out), n_splits, g, hd);
  return static_cast<int>(cudaGetLastError());
}
