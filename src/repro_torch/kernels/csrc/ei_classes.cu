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
//   total(x)  = sum_i member[i, x] * EI_i(x)  (ei::ei_total_column)
//
// The tenant sum is the one the EIrate and EIrate top-k kernels compute
// (ei_column.cuh, same flags), so row c is bit-equal to the EIrate kernel
// run with cost row c wherever that row is finite; with C = 1, rate 1 and
// overhead 0 the batched decision's head is the sequential decision's pick.
//
// Bound on an H100: each input read once and each output written once is
// N*n bytes of membership, 9n of mu, sigma and selected, 4N of best and 8Cn
// of cost read and scores written, over 3.35 TB/s.  The erf/exp work grows
// with the member (tenant, model) pairs: with disjoint membership (the
// device plane's tenant blocks) the pass is bound by bytes, with dense
// membership by operations (about 15 per member pair, over 67 TFLOP/s).
//
// Design: one thread per model column, adjacent threads on adjacent
// columns.  The thread walks the tenants once into a register (the TPU
// kernel accumulates into row 0 of its output block and fans out in its
// last tenant step), then loops over the C cost rows: each row is read and
// written coalesced, so a C-class pass reads membership exactly as often as
// a one-class pass.  No cross-thread reduction: the sum order is fixed and
// equal inputs give bit-equal scores.

#include <cuda_runtime.h>

#include <cmath>

#include "ei_column.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void eirate_classes_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ best,
    const unsigned char* __restrict__ membership,
    const float* __restrict__ cost, const unsigned char* __restrict__ selected,
    float* __restrict__ out, int N, int n, int C) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  const float total =
      ei::ei_total_column(mu, sigma, best, membership, N, n, x);
  const bool sel = selected[x];
  for (int c = 0; c < C; ++c) {
    const size_t at = static_cast<size_t>(c) * n + x;
    const float cx = cost[at];
    out[at] = (sel || !isfinite(cx)) ? ei::kSelected : ei::ftz(total / cx);
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
  const int blocks = (n + kThreads - 1) / kThreads;
  eirate_classes_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      mu, sigma, best, membership, cost, selected, out, N, n, C);
  return static_cast<int>(cudaGetLastError());
}
