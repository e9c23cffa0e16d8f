// W8A8 PIM-style GEMV for Hopper (sm_90a): int8 W (N,K) x int8 x (B,K) -> f32 (B,N).
//
// Replaces: the Pallas kernel `pim_gemv` (src/repro/kernels/pim_gemv/pim_gemv.py:55,
// body `_gemv_kernel` :31), the CD-PIM compute unit's int8 MAC pipeline with exact
// int32 accumulation and the dequant epilogue acc * x_scale[b] * w_scale[n] (:51).
//
// Bound on the H100: the weight bytes. Every weight byte is read once and used for
// B <= 8 multiply-adds, about B int8 operations a byte against the ~590 the int8
// tensor cores need, so the kernel is a weight stream at 3.35 TB/s (N*K bytes; 218 MB
// per llama3-8b layer for the seven GEMVs). What it has to get right is keeping
// enough weight bytes in flight on every SM, with little fixed cost per call.
//
// What held the earlier design (one warp per row, x staged whole in shared memory,
// __dp4a against it, a shuffle tree per row) back, and what this one does about it:
//   * x was re-read from shared memory for every weight row (B 16-byte reads per 16
//     weight bytes, near the SM's shared-memory rate at B 8). Here the products run
//     on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32): a tile of 16
//     weight rows is the A operand and the (up to) 8 batch rows of x the n = 8 B
//     operand, so each x fragment is loaded once per 64 K and serves all 16 rows.
//     Integer sums are exact in any order, so K may be assigned to the fragments'
//     slots in any way that A and B share: a thread takes 16 contiguous bytes of its
//     row (and of its batch row of x) and feeds bytes 0-7 to one mma and 8-15 to the
//     next. No shuffle tree: the accumulator fragment holds finished dot products.
//   * Whole-x staging capped occupancy (114,688 bytes a block at (4096, 14336) B 8)
//     and made every block copy x and wait before its first weight load. Here x is
//     not staged whole: it comes in 128-byte K tiles beside the weight tiles, so a
//     block's shared memory (40 KB) does not grow with B or K.
//   * Few weight bytes were in flight where blocks were few or rows short. Here one
//     producer warp moves (64 rows x 128 K) weight tiles and the matching (<= 8 x 128)
//     x tiles through the copy engine (cp.async.bulk.tensor, 128-byte swizzle) into a
//     ring of kStages stages with full/empty mbarriers; four consumer warps (16 rows
//     each) run the products as tiles land. Four stages of 9 KB keep 36 KB in flight
//     per block, and up to five blocks fit an SM.
//   * Narrow N left SMs idle ((1024, 4096): 128 blocks of one 4 KB row per warp).
//     Here the grid is sized to the SMs: (64-row tiles, K splits, batch groups) with
//     the K splits chosen so that the grid holds about two blocks per SM, at most 8.
//     The splits of one row tile form a thread-block cluster: each block adds its
//     int32 partials into block 0's shared memory (distributed shared memory;
//     integer adds, so their order does not matter) and block 0, after a cluster
//     barrier, runs the f32 epilogue once, on the full sum. One kernel: no scratch
//     and no second launch. A tile of one split runs without a cluster.
//   * Fixed costs decide the shapes under ~16 MB (the bound of (1024, 1024) is 0.3
//     us). The launch is a programmatic dependent of the kernel before it: the
//     prologue (barriers, the tensor maps' prefetch, block 0's zeroed partials, the
//     cluster's first arrival) runs before griddepcontrol.wait, which holds every
//     global read, and the kernel lets the next one launch as soon as its blocks
//     have started. Chosen on the card from a sweep of stages (4, 6, 8), the
//     grid's target (1 or 2 blocks per SM) and where the next kernel may launch.
// Bank conflicts: the swizzle keeps chunk c of a 128-byte row r at c ^ (r & 7). The
// 16 mma rows of a warp map to tile rows so that the two rows a quarter-warp reads
// differ by 4 in (r & 7) (mma row g <-> row (g >> 1) | (g & 1) << 2), and the batch
// rows of x the same way (mma column g <-> batch row of that index): every 16-byte
// shared read of a quarter-warp covers all 32 banks once.
//
// The epilogue is (float)acc * x_scale[b] * w_scale[n], rounded in that order, so the
// result is bit-identical to the plain version. Ragged N and a K that is not a
// multiple of 128 are read as zeros past the edge by the copy engine (rows past N are
// never stored); batch rows past B read as zeros too. Any B: grid.z walks groups of 8
// batch rows, each re-streaming the weights (past 8 rows a GEMV is no longer a weight
// stream in the PIM sense). What the copy engine cannot take (K % 16 != 0, w or x not
// 16-byte aligned, K < 128 or N < 64) runs a plain kernel: one warp per weight row,
// byte loads, int32 sums in registers and a shuffle reduction.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxB = 8;                          // batch rows of a group: the mma's n
constexpr int kConsumers = 4;                     // consumer warps, 16 weight rows each
constexpr int kRows = 16 * kConsumers;            // weight rows of a tile
constexpr int kThreads = 32 * (kConsumers + 1);   // + the producer warp
constexpr int kKTile = 128;                       // K bytes of a stage: one swizzled row
constexpr int kStages = 4;
constexpr int kWBytes = kRows * kKTile;           // 8192
constexpr int kStageBytes = kWBytes + kMaxB * kKTile;   // + x: 9216, a multiple of 1024
constexpr int kMaxSplits = 8;                     // cluster size (portable)
constexpr int kBlocksPerSm = 2;                   // the grid's target
// 1024 to align the stages (the 128-byte swizzle repeats every 1024 bytes), 1024 for
// the barriers, the stages, then the tile's int32 partials (kMaxB, kRows)
constexpr int kSmem = 1024 + 1024 + kStages * kStageBytes + kMaxB * kRows * 4;
constexpr int kSimpleWarps = 8;                   // rows of a block of the plain kernel

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

// arrive once and expect ``bytes`` of copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
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

// one box of a 2-D tensor map at element (x, y) -> shared memory, counted on ``bar``
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// c += A (16 x 32, rows g / g + 8 in a0, a2 / a1, a3) * B (32 x 8, column g in b0, b1)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the tile row (and batch row) that mma row (column) i < 8 stands for
__host__ __device__ constexpr int spread(int i) { return (i >> 1) | ((i & 1) << 2); }

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

struct Geom {
  int n_rows, batch;
  int k_tiles;        // 128-byte K tiles of a row
  int kt_per_split;   // K tiles of one split (the last may hold fewer)
  int x_rows;         // rows of the x box: min(8, B)
};

__device__ __forceinline__ void cluster_arrive() {   // release: this block's writes
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {     // acquire: every block's
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// grid (64-row tiles, K splits, batch groups). kCluster: the K splits of a row tile
// are one cluster whose blocks add their int32 partials into block 0's shared
// memory; otherwise a block owns its tile's outputs.
template <bool kCluster>
__global__ void __launch_bounds__(kThreads)
pim_gemv_tc_kernel(const __grid_constant__ CUtensorMap tmw, const __grid_constant__ CUtensorMap tmx,
                   const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                   float* __restrict__ out, const Geom geo) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kStages;
  unsigned char* stages = base + 1024;
  int* part = reinterpret_cast<int*>(stages + kStages * kStageBytes);   // (kMaxB, kRows)
  const uint32_t stages_s = smem_u32(stages);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int b0 = blockIdx.z * kMaxB;
  const int kt0 = blockIdx.y * geo.kt_per_split;
  const int n_kt = min(geo.kt_per_split, geo.k_tiles - kt0);
  const bool owner = blockIdx.y == 0;   // the cluster's rank 0: it sums and stores

  // prologue, which may overlap the previous kernel (a programmatic dependent
  // launch): nothing here reads memory that kernel writes
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmw)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (owner)
    for (int i = tid; i < kMaxB * kRows; i += kThreads) part[i] = 0;
  __syncthreads();
  if constexpr (kCluster) cluster_arrive();   // the owner's zeros, waited on below
  asm volatile("griddepcontrol.wait;" ::: "memory");   // x, the scales and W are written
  // the next kernel may launch once every block of this one has started; it
  // waits on the card for this one's writes (its own griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");

  int acc[4] = {0, 0, 0, 0};
  const int g = lane >> 2, t = lane & 3;
  const int rg = spread(g);
  if (warp == kConsumers) {
    // the producer: tile j into stage j % kStages once the consumers freed it
    if (lane == 0) {
      const uint32_t tx = static_cast<uint32_t>(kWBytes + geo.x_rows * kKTile);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], static_cast<uint32_t>((j / kStages - 1) & 1));
        unsigned char* st = stages + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], tx);
        const int kx = (kt0 + j) * kKTile;
        tma_2d(st, &tmw, kx, row0, &full[s]);
        tma_2d(st + kWBytes, &tmx, kx, b0, &full[s]);
      }
    }
    __syncwarp();
  } else {
    // consumer warp: tile rows warp * 16 + rg and + 8 are mma rows g and g + 8;
    // batch row rg is mma column g
    const uint32_t w_lo = static_cast<uint32_t>((warp * 16 + rg) * kKTile);
    const uint32_t w_hi = w_lo + 8 * kKTile;
    const uint32_t x_row = static_cast<uint32_t>(kWBytes + rg * kKTile);
    const bool x_live = rg < geo.x_rows;   // rows past the box were never written
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], static_cast<uint32_t>((j / kStages) & 1));
      const uint32_t st = stages_s + static_cast<uint32_t>(s * kStageBytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // logical 16-byte chunk 4h + t of each 128-byte row, at (4h + t) ^ (row & 7);
        // row & 7 is rg for the weight rows and for x
        const uint32_t pc = static_cast<uint32_t>(((4 * h + t) ^ rg) << 4);
        const uint4 wa = lds128(st + w_lo + pc);
        const uint4 wb = lds128(st + w_hi + pc);
        uint4 xv = lds128(st + x_row + pc);
        if (!x_live) xv = make_uint4(0u, 0u, 0u, 0u);
        mma_s8(acc, wa.x, wb.x, wa.y, wb.y, xv.x, xv.y);
        mma_s8(acc, wa.z, wb.z, wa.w, wb.w, xv.z, xv.w);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // C: rows g (acc 0, 1) and g + 8 (acc 2, 3), columns 2t and 2t + 1, into the
  // owner's partials (batch row, tile row)
  int* dst = part;
  if constexpr (kCluster) {
    cluster_wait();
    dst = cg::this_cluster().map_shared_rank(part, 0);
  }
  if (warp < kConsumers) {
    const int r = warp * 16 + rg;
    const int c0 = spread(2 * t), c1 = spread(2 * t + 1);
    atomicAdd(dst + c0 * kRows + r, acc[0]);
    atomicAdd(dst + c1 * kRows + r, acc[1]);
    atomicAdd(dst + c0 * kRows + r + 8, acc[2]);
    atomicAdd(dst + c1 * kRows + r + 8, acc[3]);
  }
  if constexpr (kCluster) {
    cluster_arrive();
    cluster_wait();
    if (!owner) return;
  } else {
    __syncthreads();
  }
  // the epilogue, once per output: consecutive threads take consecutive weight
  // rows of one batch row, so the stores coalesce
  for (int e = tid; e < kMaxB * kRows; e += kThreads) {
    const int bb = e / kRows, r = e - bb * kRows;
    const int n = row0 + r, b = b0 + bb;
    if (n < geo.n_rows && b < geo.batch)
      out[static_cast<int64_t>(b) * geo.n_rows + n] = epilogue(part[e], x_scale[b], w_scale[n]);
  }
}

// The plain kernel: one warp per weight row, grid (row blocks, batch groups).
__global__ void __launch_bounds__(kSimpleWarps * 32)
pim_gemv_simple_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
                       const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                       float* __restrict__ out, int n_rows, int k, int batch) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kSimpleWarps + (threadIdx.x >> 5);
  if (n >= n_rows) return;   // the whole warp
  const int b0 = blockIdx.y * kMaxB;
  const int bg = min(kMaxB, batch - b0);
  const int8_t* wr = w + static_cast<int64_t>(n) * k;
  const int8_t* xg = x + static_cast<int64_t>(b0) * k;
  int acc[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) acc[b] = 0;
  for (int kk = lane; kk < k; kk += 32) {
    const int wk = wr[kk];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < bg) acc[b] += wk * static_cast<int>(xg[static_cast<int64_t>(b) * k + kk]);
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  if (lane < bg) {
    int mine = 0;
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b == lane) mine = acc[b];
    out[static_cast<int64_t>(b0 + lane) * n_rows + n] =
        epilogue(mine, x_scale[b0 + lane], w_scale[n]);
  }
}

// A 2-D uint8 tensor map over ``rows`` rows of ``inner`` bytes (the row stride), read
// in boxes of (128, box_rows) with the 128-byte swizzle; out-of-range bytes read as
// zeros. ``cuTensorMapEncodeTiled`` is found through the runtime, so the library needs
// no -lcuda.
bool encode_2d(CUtensorMap* map, const void* base, int64_t inner, int64_t rows, int box_rows) {
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
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKTile), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// How a call is cut: the tensor-core path where the copy engine takes the operands
// (vec: K % 16 == 0 and w, x 16-byte aligned; boxes no larger than the tensors).
struct Plan {
  int tc;             // 1: the tensor-core kernel; 0: the plain kernel
  int row_tiles;      // grid.x: 64-row tiles (plain kernel: blocks of 8 rows)
  int splits;         // grid.y: K splits, one cluster per row tile
  int groups;         // grid.z (plain kernel: grid.y): batch groups of 8
  int kt_per_split;   // 128-byte K tiles of a split
};

int g_sms = 0;

Plan make_plan(int n_rows, int k, int batch, int vec) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  Plan p = {};
  p.groups = (batch + kMaxB - 1) / kMaxB;
  p.tc = vec && k % 16 == 0 && k >= kKTile && n_rows >= kRows;
  p.splits = 1;
  if (!p.tc) {
    p.row_tiles = (n_rows + kSimpleWarps - 1) / kSimpleWarps;
    return p;
  }
  p.row_tiles = (n_rows + kRows - 1) / kRows;
  const int k_tiles = (k + kKTile - 1) / kKTile;
  const int64_t blocks = static_cast<int64_t>(p.row_tiles) * p.groups;
  const int64_t want = static_cast<int64_t>(kBlocksPerSm) * g_sms / blocks;
  int splits = static_cast<int>(want < 1 ? 1 : (want > kMaxSplits ? kMaxSplits : want));
  if (splits > k_tiles) splits = k_tiles;
  p.kt_per_split = (k_tiles + splits - 1) / splits;
  p.splits = (k_tiles + p.kt_per_split - 1) / p.kt_per_split;   // none left empty
  return p;
}

bool g_smem_set = false;

}  // namespace

// The cut of a call (for tests and reports): {tensor cores, grid.x, K splits, batch
// groups, K tiles per split}.
extern "C" int pim_gemv_plan(int n_rows, int k, int batch, int vec, int* plan) {
  if (batch < 1 || n_rows < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n_rows, k, batch, vec);
  plan[0] = p.tc;
  plan[1] = p.row_tiles;
  plan[2] = p.splits;
  plan[3] = p.groups;
  plan[4] = p.kt_per_split;
  return 0;
}

// w (N, K) int8, x (B, K) int8, scales f32 -> out (B, N) f32, any B >= 1 and K >= 1.
// vec: K % 16 == 0 and w, x 16-byte aligned.
extern "C" int pim_gemv_launch(const void* w, const void* x, const void* w_scale,
                               const void* x_scale, void* out, int n_rows, int k,
                               int batch, int vec, void* stream) {
  if (batch < 1 || n_rows < 1 || k < 1 || (batch + kMaxB - 1) / kMaxB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n_rows, k, batch, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wsp = static_cast<const float*>(w_scale);
  auto* xsp = static_cast<const float*>(x_scale);
  auto* op = static_cast<float*>(out);
  if (!p.tc) {
    pim_gemv_simple_kernel<<<dim3(p.row_tiles, p.groups), kSimpleWarps * 32, 0, s>>>(
        static_cast<const int8_t*>(w), static_cast<const int8_t*>(x), wsp, xsp, op, n_rows, k,
        batch);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap tmw, tmx;
  const int x_rows = batch < kMaxB ? batch : kMaxB;
  if (!encode_2d(&tmw, w, k, n_rows, kRows) || !encode_2d(&tmx, x, k, batch, x_rows))
    return static_cast<int>(cudaErrorNotSupported);
  const bool cluster = p.splits > 1;
  auto kern = cluster ? pim_gemv_tc_kernel<true> : pim_gemv_tc_kernel<false>;
  if (!g_smem_set) {   // raise the opt-in limit once
    const void* kernels[2] = {reinterpret_cast<const void*>(pim_gemv_tc_kernel<true>),
                              reinterpret_cast<const void*>(pim_gemv_tc_kernel<false>)};
    for (const void* kf : kernels) {
      const cudaError_t err =
          cudaFuncSetAttribute(kf, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    g_smem_set = true;
  }
  Geom geo;
  geo.n_rows = n_rows;
  geo.batch = batch;
  geo.k_tiles = (k + kKTile - 1) / kKTile;
  geo.kt_per_split = p.kt_per_split;
  geo.x_rows = x_rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.row_tiles, p.splits, p.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  // a programmatic dependent of the kernel before it on the stream (its prologue
  // overlaps that kernel's tail), and a cluster per row tile's K splits
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = p.splits;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, tmw, tmx, wsp, xsp, op, geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
