// Multi-tenant EIrate scoring (the paper's eqs. 3-6) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ei_score.py, eirate_pallas (pallas_call at
// line 185; body _ei_kernel, _ei_partial, _tau_terms).
//
//   EI_i(x)  = sigma(x) * tau((mu(x) - best_i) / sigma(x)),  tau(u) = u Phi(u) + phi(u)
//            = max(mu(x) - best_i, 0)                         when sigma(x) == 0
//   score(x) = sum_i member[i, x] * EI_i(x) / c(x),  -1e30 where selected[x]
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
//
// Arithmetic: the decision path of the JAX reference (ei.py, the default
// scorer) takes Phi from jax.scipy's ndtr, with erfc in the tails, and XLA
// flushes subnormal results to zero.  This kernel does the same: ndtr() with
// erfcf below, and ftz() at the steps where a subnormal can appear, so a
// candidate whose EI underflows there scores exactly 0 here as well.  Built
// with -fmad=false so each step rounds like the plain PyTorch version's
// separate ops (kernels/ref.py), with erf/erfc/exp taken in double and
// rounded once, as that version does.

#include <cuda_runtime.h>

namespace {

constexpr float kHalfSqrt2 = 0.7071067811865476f;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kFltMin = 1.17549435e-38f;
constexpr float kSelected = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kFltMin ? 0.0f : x;
}

// erf, erfc and exp evaluated in double and rounded once to float: the same
// float on the card as in the plain version on either device, where the
// float versions of the two math libraries differ in the last bit.
__device__ __forceinline__ float erf_rn(float x) {
  return static_cast<float>(erf(static_cast<double>(x)));
}
__device__ __forceinline__ float erfc_rn(float x) {
  return static_cast<float>(erfc(static_cast<double>(x)));
}
__device__ __forceinline__ float exp_rn(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}

// Phi(u) in Cephes' form: 0.5 * (1 + erf) near the mean, erfc in the tails.
__device__ __forceinline__ float ndtr(float u) {
  const float w = u * kHalfSqrt2;
  const float z = fabsf(w);
  float y;
  if (z < kHalfSqrt2) {
    y = 1.0f + erf_rn(w);
  } else if (w > 0.0f) {
    y = 2.0f - erfc_rn(z);
  } else {
    y = erfc_rn(z);
  }
  return ftz(0.5f * y);
}

// tau(u) = u * Phi(u) + phi(u)
__device__ __forceinline__ float tau(float u) {
  const float pdf = ftz(exp_rn((kLog2Pi + u * u) / -2.0f));
  return ftz(ftz(u * ndtr(u)) + pdf);
}

__global__ void eirate_kernel(const float* __restrict__ mu,
                              const float* __restrict__ sigma,
                              const float* __restrict__ best,
                              const unsigned char* __restrict__ membership,
                              const float* __restrict__ cost,
                              const unsigned char* __restrict__ selected,
                              float* __restrict__ out, int N, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  const float m = mu[x];
  const float sg = sigma[x];
  const bool positive = sg > 0.0f;
  const float safe = positive ? sg : 1.0f;
  float total = 0.0f;
  for (int i = 0; i < N; ++i) {
    if (!membership[static_cast<size_t>(i) * n + x]) continue;
    const float diff = m - best[i];
    float ei;
    if (positive) {
      ei = ftz(safe * tau(diff / safe));
    } else {
      ei = fmaxf(diff, 0.0f);
    }
    total = total + ei;
  }
  out[x] = selected[x] ? kSelected : ftz(total / cost[x]);
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
