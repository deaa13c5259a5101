// The per-column EIrate body shared by the EIrate kernel (ei_score.cu), the
// EIrate top-k kernel (ei_topk.cu) and the class-axis EIrate kernel
// (ei_classes.cu): each computes a column's tenant sum from ei_term in
// ascending tenant order (ei_total_column), built with the same flags, so
// all three rank the very same floats.
//
//   EI_i(x)  = sigma(x) * tau((mu(x) - best_i) / sigma(x)),  tau(u) = u Phi(u) + phi(u)
//            = max(mu(x) - best_i, 0)                         when sigma(x) == 0
//   score(x) = sum_i member[i, x] * EI_i(x) / c(x),  -1e30 where selected[x]
//
// Arithmetic: the decision path of the JAX reference (ei.py, the default
// scorer) computes Phi as jax.scipy's ndtr does, with erfc in the tails; XLA
// flushes subnormal results to zero.  This code does the same: ndtr() with
// erfc below, and ftz() at the steps where a subnormal can appear, so a
// candidate whose EI underflows there scores exactly 0 here as well.  Built
// with -fmad=false so each step rounds like the plain PyTorch version's
// separate ops (kernels/ref.py), with erf/erfc/exp taken in double and
// rounded once, as that version does.  Tenants are summed in ascending order
// into one float32 accumulator, skipping non-members, so equal inputs give
// bit-equal scores.

#pragma once

#include <cuda_runtime.h>

namespace ei {

constexpr float kHalfSqrt2 = 0.7071067811865476f;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kFltMin = 1.17549435e-38f;
constexpr float kSelected = -1e30f;

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

// EI_i(x) of one (tenant, column) pair: m = mu[x], best_i = best[i], safe =
// sigma[x] where sigma[x] > 0 (positive), else 1.
__device__ __forceinline__ float ei_term(float m, float safe, bool positive,
                                         float best_i) {
  const float diff = m - best_i;
  return positive ? ftz(safe * tau(diff / safe)) : fmaxf(diff, 0.0f);
}

// The tenant sum of column x of an (N, n) problem: sum_i member[i, x] *
// EI_i(x), tenants in ascending order, non-members skipped.  (The top-k
// kernel spreads the terms over threads and adds them in this order.)
__device__ __forceinline__ float ei_total_column(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ best,
    const unsigned char* __restrict__ membership, int N, int n, int x) {
  const float m = mu[x];
  const float sg = sigma[x];
  const bool positive = sg > 0.0f;
  const float safe = positive ? sg : 1.0f;
  float total = 0.0f;
  for (int i = 0; i < N; ++i) {
    if (!membership[static_cast<size_t>(i) * n + x]) continue;
    total = total + ei_term(m, safe, positive, best[i]);
  }
  return total;
}

// The EIrate score of column x of an (N, n) problem.
__device__ __forceinline__ float eirate_column(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ best,
    const unsigned char* __restrict__ membership,
    const float* __restrict__ cost, const unsigned char* __restrict__ selected,
    int N, int n, int x) {
  const float total = ei_total_column(mu, sigma, best, membership, N, n, x);
  return selected[x] ? kSelected : ftz(total / cost[x]);
}

}  // namespace ei
