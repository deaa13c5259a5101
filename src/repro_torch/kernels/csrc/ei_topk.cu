// EIrate scoring with a block-local top-k epilogue and the merge to the
// global top-k, in one launch, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ei_score.py, eirate_topk_pallas (pallas_call
// at line 235; body _ei_topk_kernel at 130-146, _block_topk at 110-127) and
// the merge that the TPU version runs outside its kernel.
//
// Each block of bn model columns scores its columns exactly as the EIrate
// kernel does (the same ei::ei_term, tenants added in ascending order into
// one float32 accumulator, non-members skipped) and emits its kb best
// (value, global index) candidates: kb rounds of a block-wide reduction to
// the largest value, the lowest index among equal values, then that column
// masked to -1e30.  The candidates go to a scratch buffer; the last block
// to finish (a ticket from an atomic counter) merges the (blocks x kb)
// candidates to the global top-k as ref.merge_block_topk does: candidates
// with index >= n count as -1e30, the list is padded to k with (-1e30, 0),
// and equal values go to the lowest position in the flat block-major list
// (a stable sort's order).  It writes (values (k,), indices (k,)) and
// resets the counter to 0 for the next launch on the stream.
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
// Design: 1,024 threads a block, 256 columns x 4 tenant slices.  Tenants go
// in chunks of 32: the block stages the chunk's membership rows in shared
// memory (16-byte loads where n is a multiple of 16 and the base aligned),
// each slice computes the terms of every fourth tenant for its column into
// shared memory, then the column's owner (slice 0) adds the chunk's terms
// of members in ascending tenant order, so the sum is ei_total_column's
// bit for bit.  Scores stay in the owners' registers; each round is a
// warp-shuffle (value, index) reduction, then one across the 32 warps in
// shared memory.  The merge takes k rounds over the candidates, each round
// the best candidate ranked after the previous round's pick.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "ei_column.cuh"

namespace {

constexpr int kCols = 256;                 // columns of a block (bn <= 256)
constexpr int kSlices = 4;                 // threads per column for the terms
constexpr int kThreads = kCols * kSlices;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // tenants staged at a time

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

// The block's best (v, i) over every thread's pair, returned to all
// threads; two barriers.
__device__ __forceinline__ void block_best(float& v, int& i, float* warp_v,
                                           int* warp_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(v, i);
  if (lane == 0) {
    warp_v[warp] = v;
    warp_i[warp] = i;
  }
  __syncthreads();
  v = lane < kWarps ? warp_v[lane] : -INFINITY;
  i = lane < kWarps ? warp_i[lane] : INT_MAX;
  warp_best(v, i);
  v = __shfl_sync(0xffffffffu, v, 0);
  i = __shfl_sync(0xffffffffu, i, 0);
  __syncthreads();   // warp_v and warp_i are free again
}

__global__ void __launch_bounds__(kThreads)
eirate_topk_kernel(const float* __restrict__ mu, const float* __restrict__ sigma,
                   const float* __restrict__ best,
                   const unsigned char* __restrict__ membership,
                   const float* __restrict__ cost,
                   const unsigned char* __restrict__ selected,
                   float* __restrict__ cand_v, int* __restrict__ cand_i,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   unsigned int* __restrict__ counter, int N, int n, int bn,
                   int kb, int k, int vec) {
  __shared__ float terms[kChunk][kCols];
  __shared__ __align__(16) unsigned char member[kChunk][kCols];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int x = t % kCols, slice = t / kCols;
  const int base = blockIdx.x * bn;
  const int width = min(bn, n - base);       // the block's real columns
  const bool active = x < width;

  // ---- the tenant sum of column base + x, spread over four slices ----
  float m = 0.0f, safe = 1.0f;
  bool positive = false;
  if (active) {
    m = mu[base + x];
    const float sg = sigma[base + x];
    positive = sg > 0.0f;
    safe = positive ? sg : 1.0f;
  }
  float total = 0.0f;
  for (int i0 = 0; i0 < N; i0 += kChunk) {
    const int rows = min(kChunk, N - i0);
    if (vec) {             // width, n and the base are multiples of 16 bytes
      const int per_row = width / 16;
      for (int e = t; e < rows * per_row; e += kThreads) {
        const int r = e / per_row, c = e - r * per_row;
        *reinterpret_cast<uint4*>(&member[r][16 * c]) = __ldg(
            reinterpret_cast<const uint4*>(
                membership + static_cast<size_t>(i0 + r) * n + base) + c);
      }
    } else {
      for (int e = t; e < rows * width; e += kThreads) {
        const int r = e / width, c = e - r * width;
        member[r][c] = membership[static_cast<size_t>(i0 + r) * n + base + c];
      }
    }
    __syncthreads();
    if (active) {
      for (int r = slice; r < rows; r += kSlices)
        if (member[r][x]) terms[r][x] = ei::ei_term(m, safe, positive, best[i0 + r]);
    }
    __syncthreads();
    if (slice == 0 && active) {
      for (int r = 0; r < rows; ++r)
        if (member[r][x]) total = total + terms[r][x];
    }
    __syncthreads();       // the next chunk overwrites member and terms
  }

  // ---- the block's kb candidates ----
  float v;
  if (t >= bn) {
    v = -INFINITY;                  // past the block's width: never wins
  } else if (base + t >= n) {
    v = ei::kSelected;              // padding column: born selected
  } else {
    v = selected[base + t] ? ei::kSelected : ei::ftz(total / cost[base + t]);
  }
  for (int r = 0; r < kb; ++r) {
    float bv = v;
    int bi = t;
    block_best(bv, bi, warp_v, warp_i);
    if (t == 0) {
      const size_t at = static_cast<size_t>(blockIdx.x) * kb + r;
      cand_v[at] = bv;
      cand_i[at] = base + bi;
    }
    if (t == bi) v = ei::kSelected;
  }

  // ---- the last block to finish merges every block's candidates ----
  if (t == 0) {
    __threadfence();                // the candidates before the ticket
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int total_c = gridDim.x * kb;
  const int len = max(total_c, k);  // positions >= total_c: (-1e30, 0) pads
  float pv = INFINITY;              // the previous pick (value, position)
  int pp = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bp = INT_MAX;
    for (int p = t; p < len; p += kThreads) {
      float cv = ei::kSelected;
      if (p < total_c && __ldcg(cand_i + p) < n) cv = __ldcg(cand_v + p);
      // ranked after the previous pick, and better than this thread's best
      if ((cv < pv || (cv == pv && p > pp)) && beats(cv, p, bv, bp)) {
        bv = cv;
        bp = p;
      }
    }
    block_best(bv, bp, warp_v, warp_i);
    if (t == 0) {
      out_v[r] = bv;
      out_i[r] = bp < total_c ? __ldcg(cand_i + bp) : 0;
    }
    pv = bv;
    pp = bp;
  }
  if (t == 0) *counter = 0u;       // zero for the next launch on the stream
}

}  // namespace

// mu, sigma, cost (n,), best (N,), membership (N, n) and selected (n,)
// bytes; cand_v, cand_i scratch of blocks * kb; out_v, out_i (k,); counter
// one zeroed word, left zeroed.  Returns the cudaError_t of the launch.
extern "C" int eirate_topk_launch(const float* mu, const float* sigma,
                                  const float* best,
                                  const unsigned char* membership,
                                  const float* cost,
                                  const unsigned char* selected, float* cand_v,
                                  int* cand_i, float* out_v, int* out_i,
                                  unsigned int* counter, int N, int n, int bn,
                                  int kb, int k, void* stream) {
  if (n < 1 || bn < 1 || bn > kCols || kb < 1 || kb > bn || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + bn - 1) / bn;
  const int vec =
      n % 16 == 0 && reinterpret_cast<uintptr_t>(membership) % 16 == 0;
  eirate_topk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, sigma, best, membership, cost, selected, cand_v, cand_i, out_v, out_i,
      counter, N, n, bn, kb, k, vec);
  return static_cast<int>(cudaGetLastError());
}
