// W8A8 PIM-style GEMV for Hopper (sm_90a): int8 W (N,K) x int8 x (B,K) -> f32 (B,N).
//
// Replaces: the Pallas kernel `pim_gemv` (src/repro/kernels/pim_gemv/pim_gemv.py:55,
// body `_gemv_kernel` :31), the CD-PIM compute unit's int8 MAC pipeline with exact
// int32 accumulation and the dequant epilogue acc * x_scale[b] * w_scale[n] (:51).
//
// Bound on the H100: the weight bytes. Every weight byte is read exactly once and
// used for B <= 8 multiply-adds, so the arithmetic intensity is ~B int8 ops/byte,
// far below the ~590 ops/byte the int8 tensor cores need: the kernel is a weight
// stream at 3.35 TB/s (N*K bytes; 218 MB per llama3-8b layer for the seven GEMVs).
//
// Design: one warp per output row (grid-stride over rows). The activation block
// x (B*K bytes for B <= 8) is staged in dynamic shared memory -- the CU's input
// buffer. Each lane reads its share of the weight row with 16-byte streaming loads
// (ld.global.nc, no L1 allocation: weights are touched once), and multiplies them
// against the staged x with __dp4a, keeping one int32 accumulator per batch row in
// registers -- the CU's output buffer. A warp shuffle reduction finishes the row;
// integer addition is exact, so the sum order does not matter and the result is
// bit-identical to the plain version. The epilogue is
// (float)acc * x_scale[b] * w_scale[n], rounded in that order. Ragged K (K % 16 != 0
// or unaligned rows) takes a byte-wise path; ragged N is masked by the row loop.
//
// Any B and K, as the Pallas op takes them:
//   * batch groups: grid.y walks groups of 8 batch rows (the registers hold 8
//     accumulators), each group re-streaming the weights; past 8 rows a GEMV is no
//     longer weight-stream bound in the PIM sense, so this is the simple shape.
//   * K tiles: where a group's x fits the shared memory (8 * K <= 227 KB, every
//     llama3-8b GEMV), it is staged once per block as before. Otherwise x is staged
//     kKTile columns at a time: the block's warps take rows in lockstep, and for each
//     tile the block stages x[:, k0:k0 + kKTile] between two barriers while each
//     warp's int32 accumulators carry across tiles. x is then read from L2 once per
//     group of 8 rows per block, as often as the weight bytes themselves at B = 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;           // batch rows of one group (int32 accumulators a lane)
constexpr int kWarps = 8;          // rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kKTile = 8192;       // columns of x a tile stages when K does not fit whole
constexpr size_t kSmemCap = 232448;   // dynamic shared memory a block may use (H100)

// Not volatile: the weights are read-only for the kernel's life, so the compiler
// may batch several of these loads ahead of their uses (more bytes in flight).
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// x[:, k0:k0 + width] of the group's bg rows (row stride k) into shared memory as
// (bg, width), by every thread of the block. Whole rows (width == k) are one block
// of bg * k contiguous bytes and are copied flat: the whole-x GEMVs wait on this copy,
// and a per-row copy cost them 7 %, the tiles' per-element division 1.4 %.
template <bool kVec>
__device__ __forceinline__ void stage_x(int8_t* xs, const int8_t* x, int k, int k0,
                                        int width, int bg) {
  if (width == k) {
    if (kVec) {
      const int4* x4 = reinterpret_cast<const int4*>(x);
      int4* xs4 = reinterpret_cast<int4*>(xs);
      for (int i = threadIdx.x; i < bg * (k >> 4); i += kThreads) xs4[i] = x4[i];
    } else {
      for (int i = threadIdx.x; i < bg * k; i += kThreads) xs[i] = x[i];
    }
  } else if (kVec) {   // k, k0 and width are multiples of 16
    const int chunks = width >> 4;
    int4* xs4 = reinterpret_cast<int4*>(xs);
    for (int i = threadIdx.x; i < bg * chunks; i += kThreads) {
      const int b = i / chunks, c = i - b * chunks;
      xs4[i] = *reinterpret_cast<const int4*>(x + static_cast<int64_t>(b) * k + k0 + 16 * c);
    }
  } else {
    for (int i = threadIdx.x; i < bg * width; i += kThreads) {
      const int b = i / width, j = i - b * width;
      xs[i] = x[static_cast<int64_t>(b) * k + k0 + j];
    }
  }
}

// acc[b] += w[n, k0:k0 + width] . x[b, k0:k0 + width] over this lane's share, with
// the staged tile xs (bg, width) and wrow pointing at w[n, k0]
template <bool kVec>
__device__ __forceinline__ void accumulate(int (&acc)[kMaxB], const int8_t* wrow,
                                           const int8_t* xs, int width, int bg, int lane) {
  if (kVec) {
    const int chunks = width >> 4;
    const int4* w4 = reinterpret_cast<const int4*>(wrow);
    const int4* xs4 = reinterpret_cast<const int4*>(xs);
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      const int4 wv = ld_stream(w4 + c);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < bg) {
          const int4 xv = xs4[b * chunks + c];
          int a = acc[b];
          a = __dp4a(wv.x, xv.x, a);
          a = __dp4a(wv.y, xv.y, a);
          a = __dp4a(wv.z, xv.z, a);
          a = __dp4a(wv.w, xv.w, a);
          acc[b] = a;
        }
      }
    }
  } else {
    for (int kk = lane; kk < width; kk += 32) {
      const int wk = wrow[kk];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        if (b < bg) acc[b] += wk * static_cast<int>(xs[b * width + kk]);
    }
  }
}

// warp-reduce the accumulators and write out[b, n] for the group's rows
__device__ __forceinline__ void finish_row(int (&acc)[kMaxB], const float* x_scale,
                                           const float* w_scale, float* out, int n,
                                           int n_rows, int bg, int lane) {
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  if (lane < bg) {
    int mine = 0;
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b == lane) mine = acc[b];
    const float y = __fmul_rn(__fmul_rn(__int2float_rn(mine), x_scale[lane]), w_scale[n]);
    out[static_cast<int64_t>(lane) * n_rows + n] = y;
  }
}

// grid (row blocks, batch groups). kTiled: x staged in tiles of kt columns;
// otherwise whole, once per block. Separate control flow: running the whole-x path
// (every llama3-8b GEMV) through the tiled loop's barriers and lockstep cost it 9 %
// at 14336 x 4096.
template <bool kVec, bool kTiled>
__global__ void __launch_bounds__(kThreads)
pim_gemv_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
                const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                float* __restrict__ out, int n_rows, int k, int batch, int kt) {
  extern __shared__ int4 smem4[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.y * kMaxB;
  const int bg = min(kMaxB, batch - b0);
  x += static_cast<int64_t>(b0) * k;
  x_scale += b0;
  out += static_cast<int64_t>(b0) * n_rows;

  if constexpr (!kTiled) {
    // the group's activation block (the CU input buffer), staged once per block
    stage_x<kVec>(xs, x, k, 0, k, bg);
    __syncthreads();
    for (int n = blockIdx.x * kWarps + warp; n < n_rows; n += gridDim.x * kWarps) {
      int acc[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[b] = 0;
      accumulate<kVec>(acc, w + static_cast<int64_t>(n) * k, xs, k, bg, lane);
      finish_row(acc, x_scale, w_scale, out, n, n_rows, bg, lane);
    }
  } else {
    // K tiles: the block's warps walk rows in lockstep (every warp reaches every
    // barrier, a warp past the last row only helps stage)
    for (int base = blockIdx.x * kWarps; base < n_rows; base += gridDim.x * kWarps) {
      const int n = base + warp;
      const bool live = n < n_rows;
      int acc[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[b] = 0;
      for (int k0 = 0; k0 < k; k0 += kt) {
        const int width = min(kt, k - k0);
        __syncthreads();                     // the previous tile is consumed
        stage_x<kVec>(xs, x, k, k0, width, bg);
        __syncthreads();
        if (live)
          accumulate<kVec>(acc, w + static_cast<int64_t>(n) * k + k0, xs, width, bg, lane);
      }
      if (live) finish_row(acc, x_scale, w_scale, out, n, n_rows, bg, lane);
    }
  }
}

int g_sms = 0;
size_t g_smem_set = 0;

}  // namespace

// w (N, K) int8, x (B, K) int8, scales f32 -> out (B, N) f32, any B >= 1 and K >= 1.
// vec: K % 16 == 0 and w, x 16-byte aligned (the 16-byte path).
extern "C" int pim_gemv_launch(const void* w, const void* x, const void* w_scale,
                               const void* x_scale, void* out, int n_rows, int k,
                               int batch, int vec, void* stream) {
  if (batch < 1 || n_rows < 1 || k < 1 || (batch + kMaxB - 1) / kMaxB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int bg = batch < kMaxB ? batch : kMaxB;
  const int kt = static_cast<size_t>(bg) * k <= kSmemCap ? k : kKTile;
  const size_t smem = static_cast<size_t>(bg) * (kt < k ? kt : k);
  int blocks = (n_rows + kWarps - 1) / kWarps;
  const int cap = g_sms * 8;  // grid-stride beyond this: x is staged once per block
  if (blocks > cap) blocks = cap;
  const dim3 grid(blocks, (batch + kMaxB - 1) / kMaxB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024 && smem > g_smem_set) {   // raise the opt-in limit once
    const void* kernels[4] = {reinterpret_cast<const void*>(pim_gemv_kernel<true, false>),
                              reinterpret_cast<const void*>(pim_gemv_kernel<false, false>),
                              reinterpret_cast<const void*>(pim_gemv_kernel<true, true>),
                              reinterpret_cast<const void*>(pim_gemv_kernel<false, true>)};
    for (const void* kern : kernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    g_smem_set = smem;
  }
  auto* wp = static_cast<const int8_t*>(w);
  auto* xp = static_cast<const int8_t*>(x);
  auto* wsp = static_cast<const float*>(w_scale);
  auto* xsp = static_cast<const float*>(x_scale);
  auto* op = static_cast<float*>(out);
  const bool tiled = kt < k;
  if (vec && !tiled)
    pim_gemv_kernel<true, false><<<grid, kThreads, smem, s>>>(wp, xp, wsp, xsp, op, n_rows, k,
                                                             batch, kt);
  else if (!tiled)
    pim_gemv_kernel<false, false><<<grid, kThreads, smem, s>>>(wp, xp, wsp, xsp, op, n_rows, k,
                                                              batch, kt);
  else if (vec)
    pim_gemv_kernel<true, true><<<grid, kThreads, smem, s>>>(wp, xp, wsp, xsp, op, n_rows, k,
                                                            batch, kt);
  else
    pim_gemv_kernel<false, true><<<grid, kThreads, smem, s>>>(wp, xp, wsp, xsp, op, n_rows, k,
                                                             batch, kt);
  return static_cast<int>(cudaGetLastError());
}
