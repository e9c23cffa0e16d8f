// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `ssd_scan` (src/repro/kernels/ssd_scan/ssd_scan.py:63,
// body `_ssd_kernel` :20): per (batch, head) a (P, N) f32 state is carried across
// chunks of Q steps; inside a chunk the outputs are the decay-masked product
//   y[t] = sum_{s<=t} (c_t . b_s) exp(al_t - al_s) x[s] + exp(al_t) S c_t
// with al the cumulative log decay of the chunk, and the state moves on as
//   S' = exp(al_Q) S + sum_s exp(al_Q - al_s) x[s] (x) b[s].
//
// Work. Per chunk and head this kernel does about Q^2 (N + P) / 2 + 2 Q P N
// f32 multiply-adds (the scores, the intra-chunk product, the carried-state
// product and the state update). The function itself needs fewer: the
// recurrence takes 5 P N flops per step and head (decay, outer-product update,
// output), 2.4x fewer at Q = 256, P = N = 64, and that count sets the bound:
// against the (2P + 1) * 4 bytes per step and head that must move (x in, y
// out, the decay; b and c are shared by the heads) it is some 40 flops a
// byte, above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s is 20 flops a
// byte), so the bound is the f32 pipes, not device memory.
//
// Design (a simple kernel that is right first):
//   * One block of 256 threads per (head, lane): grid (H, B). The TPU kernel's
//     sequential chunk axis becomes a loop inside the block, and the state lives
//     in shared memory for the whole walk, as it lived in VMEM scratch there.
//   * Per chunk the block stages x (Q, P) and b (Q, N) in shared memory, scans
//     the Q log decays (Hillis-Steele over the block), then walks the chunk in
//     tiles of 32 output rows: a tile of c rows, the decay-masked scores of the
//     tile against every visible column (s <= t), and the tile's outputs. The
//     state update comes last and reads the chunk's x and b once more.
//   * Plain f32 FMAs on shared-memory operands. Row strides are padded by one
//     float so that threads reading a column of a tile hit distinct banks.
//   * Every input is read once per (head, lane); b and c are shared by the H
//     heads of a lane and come from L2 after the first head.
// Limits: Q <= 256 (one scan element per thread), T a multiple of Q (the wrapper
// pads with zero-decay steps), and the shared memory below within 227 KB
// (Q = 256 with P = N = 64 takes 193 KB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 32;
constexpr size_t kMaxSmem = 232448;

inline size_t smem_bytes(int q, int p, int n) {
  return sizeof(float) * (static_cast<size_t>(q) * (p + 1) + static_cast<size_t>(q) * (n + 1) +
                          kRowTile * (n + 1) + static_cast<size_t>(kRowTile) * q +
                          static_cast<size_t>(p) * (n + 1) + 2 * q);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ s_out, int t_len, int h, int p, int n, int q) {
  extern __shared__ float smem[];
  const int pp = p + 1, np = n + 1;      // padded row strides
  float* xs = smem;                      // (q, pp)  the chunk's inputs
  float* bs = xs + q * pp;               // (q, np)  the chunk's b rows
  float* cs = bs + q * np;               // (kRowTile, np)  a tile of c rows
  float* gs = cs + kRowTile * np;        // (kRowTile, q)   decay-masked scores
  float* st = gs + kRowTile * q;         // (p, np)  the carried state
  float* al = st + p * np;               // (q)  cumulative log decay
  float* wq = al + q;                    // (q)  exp(al_Q - al_s)

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t bh = static_cast<int64_t>(bi) * h + hi;
  const int64_t row0 = static_cast<int64_t>(bi) * t_len;   // first (b, t) row of lane bi

  for (int e = tid; e < p * n; e += kThreads) st[(e / n) * np + e % n] = s0[bh * p * n + e];

  const int n_chunks = t_len / q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int64_t t0 = row0 + static_cast<int64_t>(ch) * q;
    __syncthreads();   // the previous chunk is done with xs, bs, al, wq and st
    for (int e = tid; e < q * p; e += kThreads) {
      const int r = e / p, col = e - r * p;
      xs[r * pp + col] = x[((t0 + r) * h + hi) * p + col];
    }
    for (int e = tid; e < q * n; e += kThreads) {
      const int r = e / n, col = e - r * n;
      bs[r * np + col] = bm[(t0 + r) * n + col];
    }
    if (tid < q) al[tid] = a[(t0 + tid) * h + hi];
    __syncthreads();
    for (int off = 1; off < q; off <<= 1) {   // inclusive scan of the log decays
      const float add = (tid < q && tid >= off) ? al[tid - off] : 0.f;
      __syncthreads();
      if (tid < q) al[tid] += add;
      __syncthreads();
    }
    const float al_last = al[q - 1];
    if (tid < q) wq[tid] = expf(al_last - al[tid]);

    for (int r0 = 0; r0 < q; r0 += kRowTile) {
      const int rows = min(kRowTile, q - r0);
      const int cols = r0 + rows;             // columns s <= t of the tile's last row
      __syncthreads();                        // the previous tile is done with cs, gs
      for (int e = tid; e < rows * n; e += kThreads) {
        const int r = e / n, col = e - r * n;
        cs[r * np + col] = cm[(t0 + r0 + r) * n + col];
      }
      __syncthreads();
      for (int e = tid; e < rows * cols; e += kThreads) {
        const int r = e / cols, s = e - r * cols;
        const int t = r0 + r;
        float g = 0.f;
        if (s <= t) {
          float dot = 0.f;
          for (int k = 0; k < n; ++k) dot = fmaf(cs[r * np + k], bs[s * np + k], dot);
          g = dot * expf(al[t] - al[s]);
        }
        gs[r * q + s] = g;
      }
      __syncthreads();
      for (int e = tid; e < rows * p; e += kThreads) {
        const int r = e / p, col = e - r * p;
        const int t = r0 + r;
        float intra = 0.f;
        for (int s = 0; s <= t; ++s) intra = fmaf(gs[r * q + s], xs[s * pp + col], intra);
        float inter = 0.f;
        for (int k = 0; k < n; ++k) inter = fmaf(cs[r * np + k], st[col * np + k], inter);
        y[((t0 + t) * h + hi) * p + col] = intra + expf(al[t]) * inter;
      }
    }
    __syncthreads();   // every tile has read the state of this chunk's start
    const float decay = expf(al_last);
    for (int e = tid; e < p * n; e += kThreads) {
      const int col = e / n, k = e - col * n;
      float acc = 0.f;
      for (int s = 0; s < q; ++s) acc = fmaf(wq[s] * xs[s * pp + col], bs[s * np + k], acc);
      st[col * np + k] = st[col * np + k] * decay + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < p * n; e += kThreads) s_out[bh * p * n + e] = st[(e / n) * np + e % n];
}

}  // namespace

// x (B, T, H, P), a (B, T, H), b and c (B, T, N), s0 (B, H, P, N), all f32 ->
// y (B, T, H, P) f32 and s_out (B, H, P, N) f32. T must be a multiple of q.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               const void* s0, void* y, void* s_out, int batch, int t_len,
                               int h, int p, int n, int q, void* stream) {
  if (batch < 1 || h < 1 || p < 1 || n < 1 || q < 1 || q > kThreads || t_len % q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(q, p, n);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t smem_set = 0;   // raise the opt-in limit once per size
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  ssd_scan_kernel<<<dim3(h, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_out), t_len, h, p, n, q);
  return static_cast<int>(cudaGetLastError());
}
