// Multi-tenant EIrate scoring (the paper's eqs. 3-6) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ei_score.py, eirate_pallas (pallas_call at
// line 185; body _ei_kernel, _ei_partial, _tau_terms).
//
//   out[x] = -1e30 where selected[x], else ftz(total(x) / cost[x]),
//   total(x) = sum_i member[i, x] * EI_i(x) in ascending tenant order
//
// Bound on an H100, the larger of two floors.  Bytes: the (N, n) uint8
// membership matrix read once, plus 13n bytes of mu, sigma, cost and
// selected, 4N of best and 4n of scores written, over 3.35 TB/s (30 us at
// N = 1,000, n = 100,000).  FP64: each member pair with sigma > 0 takes
// erf or erfc, and exp, in double (the rule that keeps the scores bit-equal
// to the plain version): 56 DFMA, DADD and DMUL on ndtr's erf branch and
// 77 on its erfc branch with CUDA 12.9 (erf has no branch of its own),
// executed counts that chip_smoke.py reads from a counting build of the
// term, over the card's 1.7e13 FP64 instructions a second.  Disjoint
// membership (the paper's workloads: one owner a model) is bound by bytes,
// dense membership by FP64.
//
// Design: ei::tile_totals (ei_column.cuh), one block of 256 threads per
// tile of 32 columns.  The tenant axis is spread over the block: each warp
// loads 32-tenant chunks of the membership tile with independent 16-byte
// loads, one row a lane (4-byte or byte loads where n or the base is not
// aligned), a whole slab of 256 (chunk, column) units at a time and the
// next slab's loads in flight while the block computes; warp ballots turn
// each chunk into a member mask per column.  With disjoint membership a
// column is then N/32 mask tests and one term.  The member pairs' terms are
// dealt out evenly over all 256 threads (a scan of the units' counts gives
// each pair a slot), so dense membership keeps every thread on the FP64
// work; the owner of each column adds its slots in ascending tenant order,
// so the scores are the plain version's bit for bit (argmax ties go to the
// first index).  Tiles and grids at the main paths' shapes: the Fig-5
// episode (N 50, n 2,500) runs 79 blocks, one slab of 2 chunks, 4-byte
// loads (2,500 is not a multiple of 16); N 1,000, n 100,000 runs 3,125
// blocks, four slabs of 256 tenants, two 16-byte loads a row.

#include <cuda_runtime.h>

#include "ei_column.cuh"

namespace {

template <int kVec>
__global__ void __launch_bounds__(ei::kTileThreads)
eirate_kernel(const float* __restrict__ mu, const float* __restrict__ sigma,
              const float* __restrict__ best,
              const unsigned char* __restrict__ membership,
              const float* __restrict__ cost,
              const unsigned char* __restrict__ selected,
              float* __restrict__ out, int N, int n) {
  __shared__ ei::TileScratch s;
  const int x0 = blockIdx.x * ei::kTileCols, x = x0 + threadIdx.x;
  const float total =
      ei::tile_totals<kVec>(mu, sigma, best, membership, N, n, x0, s);
  if (threadIdx.x < ei::kTileCols && x < n)
    out[x] = selected[x] ? ei::kSelected : ei::ftz(total / cost[x]);
}

}  // namespace

extern "C" int eirate_launch(const float* mu, const float* sigma,
                             const float* best, const unsigned char* membership,
                             const float* cost, const unsigned char* selected,
                             float* out, int N, int n, void* stream) {
  ei::tile_dispatch(membership, n, [&](auto load) {
    using T = decltype(load);
    eirate_kernel<T::kVec>
        <<<(n + ei::kTileCols - 1) / ei::kTileCols, ei::kTileThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            mu, sigma, best, membership, cost, selected, out, N, n);
  });
  return static_cast<int>(cudaGetLastError());
}
