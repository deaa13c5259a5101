// Class-axis EIrate scoring for the elastic device plane, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ei_score.py, eirate_classes_pallas (pallas_call
// at line 301; body _ei_classes_kernel at line 80).
//
// Computes a (C, n) score matrix, one row per device class c:
//
//   out[c, x] = -1e30                         where selected[x] or cost[c, x]
//                                             is not finite (memory gate)
//             = ftz(total(x) / cost[c, x])    otherwise,
//   total(x)  = sum_i member[i, x] * EI_i(x)  in ascending tenant order
//
// The tenant sum is the EIrate kernel's (ei::tile_totals, ei_column.cuh,
// same flags), so row c is bit-equal to the EIrate kernel run with cost row
// c wherever that row is finite; with C = 1, rate 1 and overhead 0 the
// batched decision's head is the sequential decision's pick.
//
// Bound on an H100, the larger of two floors.  Bytes: N*n of membership,
// 9n of mu, sigma and selected, 4N of best and 8Cn of cost read and scores
// written, over 3.35 TB/s.  FP64: erf or erfc, and exp, in double for each
// member pair with sigma > 0, 56 DFMA, DADD and DMUL on ndtr's erf branch
// and 77 on its erfc branch (CUDA 12.9; executed counts that chip_smoke.py
// reads from a counting build of the term), over 1.7e13 FP64 instructions
// a second.  Disjoint membership (the device plane's tenant blocks) is
// bound by bytes, dense membership by FP64.
//
// Design: the EIrate kernel's tile body (ei::tile_totals): one block of 256
// threads per 32 columns, the tenant walk spread over the block (16-byte
// row loads of 32-tenant chunks, a slab in flight at a time, ballots to
// member masks, the member terms dealt out over every thread, each
// column's owner adding its terms in ascending tenant order).  The tile's
// totals then go to shared memory and the block writes the C x 32 scores,
// each cost row read and each score row written in runs of 128 bytes, so a
// C-class pass reads membership exactly as often as a one-class pass.
// Tiles and grids at the main paths' shapes: device churn run (a) (C 1, N
// 256, n 4,096) runs 128 blocks, one slab of 8 chunks, 16-byte loads; C 4,
// N 1,000, n 100,000 runs 3,125 blocks, four slabs.

#include <cuda_runtime.h>

#include <cmath>

#include "ei_column.cuh"

namespace {

template <int kVec>
__global__ void __launch_bounds__(ei::kTileThreads)
eirate_classes_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ best,
    const unsigned char* __restrict__ membership,
    const float* __restrict__ cost, const unsigned char* __restrict__ selected,
    float* __restrict__ out, int N, int n, int C) {
  constexpr int kCols = ei::kTileCols;
  __shared__ ei::TileScratch s;
  __shared__ float totals[kCols];
  const int t = threadIdx.x, x0 = blockIdx.x * kCols;
  const float total =
      ei::tile_totals<kVec>(mu, sigma, best, membership, N, n, x0, s);
  if (t < kCols) totals[t] = total;
  __syncthreads();
  for (int e = t; e < C * kCols; e += ei::kTileThreads) {
    const int c = e / kCols, j = e - c * kCols, x = x0 + j;
    if (x >= n) continue;
    const size_t at = static_cast<size_t>(c) * n + x;
    const float cx = cost[at];
    out[at] = (selected[x] || !isfinite(cx)) ? ei::kSelected
                                             : ei::ftz(totals[j] / cx);
  }
}

}  // namespace

extern "C" int eirate_classes_launch(const float* mu, const float* sigma,
                                     const float* best,
                                     const unsigned char* membership,
                                     const float* cost,
                                     const unsigned char* selected, float* out,
                                     int N, int n, int C, void* stream) {
  if (C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ei::tile_dispatch(membership, n, [&](auto load) {
    using T = decltype(load);
    eirate_classes_kernel<T::kVec>
        <<<(n + ei::kTileCols - 1) / ei::kTileCols, ei::kTileThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            mu, sigma, best, membership, cost, selected, out, N, n, C);
  });
  return static_cast<int>(cudaGetLastError());
}
