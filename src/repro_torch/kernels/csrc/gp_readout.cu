// Incremental-GP posterior readout for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/gp_readout.py, gp_readout_pallas (pallas_call
// at line 85; body _readout_kernel).
//
//   mu(x)  = mu0(x) + sum_r alpha[r] * W[r, x]
//   var(x) = max(K_diag(x) - sum_r W[r, x]^2, 0)      (sqrt of it with emit_sd)
//
// over the k active rows of W = L^{-1} K[obs, :].  Row r of W starts at
// W + r * ldw (ldw >= n), so a column slice of a wider W (one shard's span
// of the sharded plane) is read in place.
//
// Bound on an H100: one read of W, k*n*4 bytes, over 3.35 TB/s; the four
// flops per element are far below the card's rate, so the pass is bound by
// bytes (at k = 1,024, n = 100,000: 410 MB, about 122 us).  At the Fig-5
// episode's per-tenant blocks (k <= 50, n 50: 10 KB) no kernel comes near
// that: the floor there is the launch itself.
//
// Arithmetic: each column's dot and sum of squares fold the rows in
// ascending order, one owner thread a column, two float32 accumulators:
// the order the engine's running diag_acc is summed in.  With -fmad=false
// the products and sums round as the plain PyTorch version's separate ops
// do, so the variance equals K_diag - diag_acc bit for bit; sqrtf is
// correctly rounded (nvcc's default -prec-sqrt=true), as is the plain
// version's square root taken in double.  k = 0 (a block with no
// observation yet) gives mu = mu0 and var = K_diag.  The order is fixed;
// the four paths differ only in how the bytes arrive (the wrapper,
// kernels/gp_readout.py, chooses; tools/readout_paths.py times them
// against each other):
//
// - slab (k*n + k + 2n <= 12,288 floats: the main path's blocks): one block
//   of 256 threads copies all of W's k rows and alpha into shared memory by
//   cp.async in one wave (16-byte copies where the rows are packed and
//   aligned, as IncrementalGP's W[:k] is: 3 a thread at k 50, n 50), then
//   each column's owner folds it from shared memory.  One round trip to
//   memory, not k.
// - bulk and bulk_deep (W's base and ldw 16-byte aligned, n a multiple of
//   4, k and n large: service size and the sharded scorer's column
//   slices): a block per span of 256 columns; warp 0 keeps a ring of
//   stages in shared memory filled by TMA bulk copies (one 1 KB copy a row,
//   lane j issuing rows j, j + 32, ..., completion counted on an mbarrier a
//   stage), so the other stages stay in flight while the block folds one.
//   bulk, where the blocks cover the SMs: 4 adjacent columns a thread, 4
//   stages of 16 rows (64 KB: three blocks share an SM).  bulk_deep, where
//   fewer blocks than SMs each have an SM of their own: one column a
//   thread, 3 stages of 64 rows (192 KB), alpha's rows staged through a
//   register and shared memory two stages ahead, so a block's walk down
//   the k rows waits on fewer, larger stages.
// - column (anything else: column slices at any offset, small k or n):
//   one thread a column, 4-byte loads of a row coalesced across the warp,
//   the loop unrolled by the compiler so that several rows are in flight.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSlabThreads = 256;
constexpr int kColumnThreads = 256;
constexpr int kBulkCols = 256;                  // columns a block

__device__ __forceinline__ void finish(int x, float dot, float sq, float m0, float kd,
                                       float* mu_out, float* var_out, int emit_sd) {
  mu_out[x] = m0 + dot;
  const float var = fmaxf(kd - sq, 0.0f);
  var_out[x] = emit_sd ? sqrtf(var) : var;
}

// the whole problem in one block: W's k rows packed (row stride n), then
// alpha, in shared memory; `packed`: W's rows are contiguous (ldw == n or
// k <= 1) from a 16-byte aligned base
__global__ void __launch_bounds__(kSlabThreads)
gp_readout_kernel_slab(const float* __restrict__ W, const float* __restrict__ alpha,
                       const float* __restrict__ mu0, const float* __restrict__ k_diag,
                       float* __restrict__ mu_out, float* __restrict__ var_out, int k,
                       int n, int ldw, int emit_sd, int packed) {
  extern __shared__ __align__(16) float slab[];
  const int total = k * n;
  float* a = slab + ((total + 3) & ~3);
  if (packed) {
    for (int u = threadIdx.x; u < total / 4; u += kSlabThreads)
      cp_async16(smem_u32(slab + 4 * u), W + 4 * u);
    for (int i = (total & ~3) + threadIdx.x; i < total; i += kSlabThreads)
      cp_async4(smem_u32(slab + i), W + i);
  } else {
    // element i = r n + x, stepped without a division
    int r = threadIdx.x / n, x = threadIdx.x - r * n;
    const int dr = kSlabThreads / n, dx = kSlabThreads - dr * n;
    for (int i = threadIdx.x; i < total; i += kSlabThreads) {
      cp_async4(smem_u32(slab + i), W + static_cast<size_t>(r) * ldw + x);
      r += dr;
      x += dx;
      if (x >= n) {
        x -= n;
        ++r;
      }
    }
  }
  for (int r = threadIdx.x; r < k; r += kSlabThreads) cp_async4(smem_u32(a + r), alpha + r);
  // the first column's mu0 and K_diag arrive with the wave
  const int x0 = threadIdx.x;
  const float m0 = x0 < n ? __ldg(mu0 + x0) : 0.0f;
  const float kd = x0 < n ? __ldg(k_diag + x0) : 0.0f;
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  auto fold = [&](int x, float& dot, float& sq) {
#pragma unroll 8
    for (int r = 0; r < k; ++r) {
      const float w = slab[r * n + x];
      dot = dot + a[r] * w;
      sq = sq + w * w;
    }
  };
  if (x0 < n) {
    float dot = 0.0f, sq = 0.0f;
    fold(x0, dot, sq);
    finish(x0, dot, sq, m0, kd, mu_out, var_out, emit_sd);
  }
  for (int x = x0 + kSlabThreads; x < n; x += kSlabThreads) {   // n > 256
    float dot = 0.0f, sq = 0.0f;
    fold(x, dot, sq);
    finish(x, dot, sq, __ldg(mu0 + x), __ldg(k_diag + x), mu_out, var_out, emit_sd);
  }
}

// a block per span of kBulkCols columns, kPer adjacent columns a thread;
// warp 0 issues one bulk copy a row (lane j rows j, j + 32, ...), kRows
// rows a stage, into a ring of kStages stages.  kStaged: each stage's alpha
// rows reach shared memory before the stage is folded (else each row's
// alpha is loaded in the fold)
template <int kPer, int kRows, int kStages, bool kStaged>
__global__ void __launch_bounds__(kBulkCols / kPer)
gp_readout_kernel_bulk(const float* __restrict__ W, const float* __restrict__ alpha,
                       const float* __restrict__ mu0, const float* __restrict__ k_diag,
                       float* __restrict__ mu_out, float* __restrict__ var_out, int k,
                       int n, int ldw, int emit_sd) {
  static_assert(!kStaged || kRows <= kBulkCols / kPer, "a thread stages one alpha row");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* al = ring + kStages * kRows * kBulkCols;          // [2][kRows]
  const uint32_t bars = smem_u32(al + 2 * kRows);
  const int x0 = blockIdx.x * kBulkCols;
  const int span = min(kBulkCols, n - x0);      // a multiple of 4
  const uint32_t bytes = span * 4;
  const int stages = (k + kRows - 1) / kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // thread j < kRows holds row j of the stage after next in a register: it
  // is loaded a stage before it is stored to al[], and stored a stage
  // before it is read, so its latency is never waited out
  auto alpha_row = [&](int s) {
    const int r = s * kRows + tid;
    return tid < kRows && r < k ? __ldg(alpha + r) : 0.0f;
  };
  float staged = 0.0f;
  if (kStaged) {
    if (tid < kRows) {
      al[tid] = alpha_row(0);
      al[kRows + tid] = alpha_row(1);
    }
    staged = alpha_row(2);
  }
  __syncthreads();
  auto issue = [&](int s) {   // stage s's rows into slot s % kStages, by warp 0
    if (s >= stages) return;
    const int rows = min(kRows, k - s * kRows);
    const uint32_t bar = bars + 8 * (s % kStages);
    if (lane == 0) mbar_expect_tx(bar, rows * bytes);
    __syncwarp();
    for (int j = lane; j < rows; j += 32)
      bulk_load(smem_u32(ring + ((s % kStages) * kRows + j) * kBulkCols),
                W + static_cast<size_t>(s * kRows + j) * ldw + x0, bytes, bar);
  };
  if (tid < 32)
    for (int s = 0; s < kStages; ++s) issue(s);

  const int c0 = kPer * tid;
  float dot[kPer], sq[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dot[e] = sq[e] = 0.0f;
  auto fold_row = [&](float ar, const float* row) {
    float w[kPer];
    if constexpr (kPer == 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(row + c0);
      w[0] = w4.x;
      w[1] = w4.y;
      w[2] = w4.z;
      w[3] = w4.w;
    } else {
      w[0] = row[c0];
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      dot[e] = dot[e] + ar * w[e];
      sq[e] = sq[e] + w[e] * w[e];
    }
  };
  for (int s = 0; s < stages; ++s) {
    if (kStaged && tid < kRows && s > 0) {   // stage s + 1's rows, read after this
      al[((s + 1) & 1) * kRows + tid] = staged;   // stage's barrier
      staged = alpha_row(s + 2);
    }
    const int rows = min(kRows, k - s * kRows);
    const float* slot = ring + (s % kStages) * kRows * kBulkCols;
    const float* a = al + (s & 1) * kRows;
    mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);
    if (!kStaged) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < rows) fold_row(__ldg(alpha + s * kRows + j), slot + j * kBulkCols);
    } else if (rows == kRows) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) fold_row(a[j], slot + j * kBulkCols);
    } else {
      for (int j = 0; j < rows; ++j) fold_row(a[j], slot + j * kBulkCols);
    }
    __syncthreads();   // every thread is done with the slot: refill it
    if (tid < 32) {
      fence_proxy_async();
      issue(s + kStages);
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int x = x0 + c0 + e;
    if (c0 + e < span)
      finish(x, dot[e], sq[e], __ldg(mu0 + x), __ldg(k_diag + x), mu_out, var_out,
             emit_sd);
  }
}

template <int kPer, int kRows, int kStages, bool kStaged>
int launch_bulk(const float* W, const float* alpha, const float* mu0,
                const float* k_diag, float* mu_out, float* var_out, int k, int n,
                int ldw, int emit_sd, cudaStream_t st) {
  constexpr int smem = (kStages * kRows * kBulkCols + 2 * kRows) * 4 + 8 * kStages;
  const cudaError_t attr = cudaFuncSetAttribute(   // per device: set at each launch
      gp_readout_kernel_bulk<kPer, kRows, kStages, kStaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  gp_readout_kernel_bulk<kPer, kRows, kStages, kStaged>
      <<<(n + kBulkCols - 1) / kBulkCols, kBulkCols / kPer, smem, st>>>(
          W, alpha, mu0, k_diag, mu_out, var_out, k, n, ldw, emit_sd);
  return static_cast<int>(cudaGetLastError());
}

// one thread a column
__global__ void __launch_bounds__(kColumnThreads)
gp_readout_kernel_column(const float* __restrict__ W, const float* __restrict__ alpha,
                         const float* __restrict__ mu0, const float* __restrict__ k_diag,
                         float* __restrict__ mu_out, float* __restrict__ var_out, int k,
                         int n, int ldw, int emit_sd) {
  const int x = blockIdx.x * kColumnThreads + threadIdx.x;
  if (x >= n) return;
  float dot = 0.0f;
  float sq = 0.0f;
  for (int r = 0; r < k; ++r) {
    const float w = W[static_cast<size_t>(r) * ldw + x];
    dot = dot + alpha[r] * w;
    sq = sq + w * w;
  }
  finish(x, dot, sq, mu0[x], k_diag[x], mu_out, var_out, emit_sd);
}

}  // namespace

// path: 0 slab (k*n + k + 2n <= 12,288), 1 bulk, 2 bulk_deep (both: W's base
// 16-byte aligned, ldw and n multiples of 4), 3 column; the wrapper
// chooses.  Returns the cudaError_t of the launch.
extern "C" int gp_readout_launch(const float* W, const float* alpha,
                                 const float* mu0, const float* k_diag,
                                 float* mu_out, float* var_out, int k, int n,
                                 int ldw, int emit_sd, int path, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (path == 0) {
    const size_t slab = (static_cast<size_t>(k) * n + 3) / 4 * 4 + k;
    if (slab * sizeof(float) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const int packed = aligned && (ldw == n || k <= 1);
    gp_readout_kernel_slab<<<1, kSlabThreads, slab * sizeof(float), st>>>(
        W, alpha, mu0, k_diag, mu_out, var_out, k, n, ldw, emit_sd, packed);
  } else if (path == 1 || path == 2) {
    if (!aligned || ldw % 4 != 0 || n % 4 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    return path == 1 ? launch_bulk<4, 16, 4, false>(W, alpha, mu0, k_diag, mu_out,
                                                     var_out, k, n, ldw, emit_sd, st)
                     : launch_bulk<1, 64, 3, true>(W, alpha, mu0, k_diag, mu_out,
                                                    var_out, k, n, ldw, emit_sd, st);
  } else if (path == 3) {
    gp_readout_kernel_column<<<(n + kColumnThreads - 1) / kColumnThreads,
                               kColumnThreads, 0, st>>>(W, alpha, mu0, k_diag, mu_out,
                                                        var_out, k, n, ldw, emit_sd);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
