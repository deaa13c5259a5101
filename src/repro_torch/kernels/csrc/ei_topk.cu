// EIrate scoring with a block-local top-k epilogue, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ei_score.py, eirate_topk_pallas (pallas_call
// at line 235; body _ei_topk_kernel at 130-146, _block_topk at 110-127).
//
// Each block of bn model columns scores its columns exactly as the EIrate
// kernel does (ei::eirate_column, ei_column.cuh) and emits its kb best
// (value, global index) candidates: kb rounds of a block-wide reduction to
// the largest value, the lowest index among equal values, then that column
// masked to -1e30.  The wrapper (kernels/ei_score.py) masks candidates with
// index >= n and merges the (blocks x kb) candidates to the global top-k with
// a stable sort, as the TPU version does outside its kernel.
//
// Exactly the TPU kernel's semantics, quirk included: masking writes -1e30,
// the value selected columns hold, so a block with fewer than kb live
// columns repeats its lowest -1e30 index in the later rounds.  bn is
// min(256, n) as there: with n < 256 the block is n columns wide and the
// threads past it take no part (they hold -inf, which never wins).
// Columns >= n of the last block are padding: born selected, -1e30.
//
// Bound on an H100: the scores need the same reads as the EIrate pass
// (membership N*n bytes, mu/sigma/cost 12n, selected n, best 4N); only
// 8 bytes per candidate are written.  With disjoint membership the pass is
// bound by bytes, with dense membership by the erf/exp operations; the kb
// reduction rounds add about kb*n compares.
//
// Design: one thread per column (256 threads = one model block), scores
// kept in registers, each round a warp-shuffle (value, index) reduction,
// then one across the 8 warps in shared memory; two barriers per round.
// Simple and exact; fusing the merge or overlapping rounds is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "ei_column.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v1, i1) ranks before (v0, i0): larger value, or equal value, lower index
__device__ __forceinline__ bool beats(float v1, int i1, float v0, int i0) {
  return v1 > v0 || (v1 == v0 && i1 < i0);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void eirate_topk_kernel(const float* __restrict__ mu,
                                   const float* __restrict__ sigma,
                                   const float* __restrict__ best,
                                   const unsigned char* __restrict__ membership,
                                   const float* __restrict__ cost,
                                   const unsigned char* __restrict__ selected,
                                   float* __restrict__ topv,
                                   int* __restrict__ topi, int N, int n, int bn,
                                   int kb) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int winner;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int base = blockIdx.x * bn;
  float v;
  if (t >= bn) {
    v = -INFINITY;                  // past the block's width: never wins
  } else if (base + t >= n) {
    v = ei::kSelected;              // padding column: born selected
  } else {
    v = ei::eirate_column(mu, sigma, best, membership, cost, selected, N, n,
                          base + t);
  }
  for (int r = 0; r < kb; ++r) {
    float bv = v;
    int bi = t;
    warp_best(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? warp_v[lane] : -INFINITY;
      bi = lane < kWarps ? warp_i[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        const size_t out = static_cast<size_t>(blockIdx.x) * kb + r;
        topv[out] = bv;
        topi[out] = base + bi;
        winner = bi;
      }
    }
    __syncthreads();
    if (t == winner) v = ei::kSelected;
  }
}

}  // namespace

extern "C" int eirate_topk_launch(const float* mu, const float* sigma,
                                  const float* best,
                                  const unsigned char* membership,
                                  const float* cost,
                                  const unsigned char* selected, float* topv,
                                  int* topi, int N, int n, int bn, int kb,
                                  void* stream) {
  if (bn < 1 || bn > kThreads || kb < 1 || kb > bn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + bn - 1) / bn;
  eirate_topk_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      mu, sigma, best, membership, cost, selected, topv, topi, N, n, bn, kb);
  return static_cast<int>(cudaGetLastError());
}
