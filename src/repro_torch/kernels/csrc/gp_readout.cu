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
// bytes (at k = 1,024, n = 100,000: 410 MB, about 122 us).
//
// Design: one thread per column x, adjacent threads on adjacent columns, so
// each row of W is read coalesced and W is read exactly once for both
// outputs.  Each thread walks the rows in ascending order with two float32
// accumulators, the order the engine's running diag_acc is summed in; with
// -fmad=false the products and sums round as the plain PyTorch version's
// separate ops do, so the variance equals K_diag - diag_acc bit for bit;
// sqrtf is correctly rounded (nvcc's default -prec-sqrt=true), as is the
// plain version's square root taken in double.
// k = 0 (a block with no observation yet) gives mu = mu0 and var = K_diag.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gp_readout_kernel(const float* __restrict__ W,
                                  const float* __restrict__ alpha,
                                  const float* __restrict__ mu0,
                                  const float* __restrict__ k_diag,
                                  float* __restrict__ mu_out,
                                  float* __restrict__ var_out, int k, int n,
                                  int ldw, int emit_sd) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float dot = 0.0f;
  float sq = 0.0f;
  for (int r = 0; r < k; ++r) {
    const float w = W[static_cast<size_t>(r) * ldw + x];
    dot = dot + alpha[r] * w;
    sq = sq + w * w;
  }
  mu_out[x] = mu0[x] + dot;
  const float var = fmaxf(k_diag[x] - sq, 0.0f);
  var_out[x] = emit_sd ? sqrtf(var) : var;
}

}  // namespace

extern "C" int gp_readout_launch(const float* W, const float* alpha,
                                 const float* mu0, const float* k_diag,
                                 float* mu_out, float* var_out, int k, int n,
                                 int ldw, int emit_sd, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  gp_readout_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      W, alpha, mu0, k_diag, mu_out, var_out, k, n, ldw, emit_sd);
  return static_cast<int>(cudaGetLastError());
}
