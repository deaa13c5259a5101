// Multi-tenant EIrate scoring (the paper's eqs. 3-6) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ei_score.py, eirate_pallas (pallas_call at
// line 185; body _ei_kernel, _ei_partial, _tau_terms).
//
// The per-column arithmetic is ei::eirate_column (ei_column.cuh), shared
// with the top-k kernel (ei_topk.cu).
//
// Bound on an H100: the (N, n) uint8 membership matrix is the only input that
// grows with N*n, so the byte floor is N*n bytes over 3.35 TB/s (about 30 us
// at N = 1,000, n = 100,000).  The erf/exp work scales with the number of
// member (tenant, model) pairs: with disjoint candidate sets (the paper's
// workloads) that is n and the pass is bound by bytes; with dense membership
// it is N*n evaluations and the pass is bound by operations.
//
// Design: one thread per model column, adjacent threads on adjacent columns,
// so each row of membership is read coalesced and read once (the TPU version
// pads membership into a float32 tile; this one reads the bytes as they are).
// Each thread walks the tenants in ascending order into one float32
// accumulator and skips non-members, so erf/exp run only for member pairs.
// There is no cross-thread reduction: the sum order is fixed, the result is
// deterministic, and equal inputs give bit-equal scores (argmax ties go to
// the first index).

#include <cuda_runtime.h>

#include "ei_column.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void eirate_kernel(const float* __restrict__ mu,
                              const float* __restrict__ sigma,
                              const float* __restrict__ best,
                              const unsigned char* __restrict__ membership,
                              const float* __restrict__ cost,
                              const unsigned char* __restrict__ selected,
                              float* __restrict__ out, int N, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  out[x] = ei::eirate_column(mu, sigma, best, membership, cost, selected, N,
                             n, x);
}

}  // namespace

extern "C" int eirate_launch(const float* mu, const float* sigma,
                             const float* best, const unsigned char* membership,
                             const float* cost, const unsigned char* selected,
                             float* out, int N, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  eirate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, sigma, best, membership, cost, selected, out, N, n);
  return static_cast<int>(cudaGetLastError());
}
