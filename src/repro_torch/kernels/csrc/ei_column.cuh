// The EIrate arithmetic shared by the EIrate kernel (ei_score.cu), the
// EIrate top-k kernel (ei_topk.cu) and the class-axis EIrate kernel
// (ei_classes.cu): one (tenant, column) term, ei_term, and a column's tenant
// sum in ascending tenant order (ei_total_column defines it), built with the
// same flags, so all three rank the very same floats.  The EIrate and
// class-axis kernels compute that sum for a tile of columns with the
// block-wide body tile_totals below.
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

#include <cstdint>

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
// EI_i(x), tenants in ascending order, non-members skipped, in one thread.
// It defines the order; the kernels spread the walk and the terms over
// their blocks (tile_totals below, the top-k kernel's tenant slices) and add
// the terms in this order, so each column's total is this one bit for bit.
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

// ---- the tile body of the EIrate and class-axis EIrate kernels ----------------
//
// A block of kTileThreads threads computes the tenant sums of kTileCols
// adjacent columns, one slab of 32 * 256 / kTileCols tenants after another:
//   1. load: each warp takes 32-tenant chunks, one membership row a lane,
//      the row's kTileCols bytes in 16-byte loads (4-byte or byte loads
//      where n or the base is not aligned); the next slab's loads are
//      issued before this slab's terms, so they are in flight while the
//      block computes; kTileCols warp ballots turn a chunk into one 32-bit
//      member mask per column;
//   2. scan: the member counts of the slab's 256 (chunk, column) units,
//      chunk-major, give each unit's first slot in a term buffer (a
//      block-wide exclusive scan, one unit a thread);
//   3. terms: the slab's member pairs are dealt out evenly, each thread a
//      run of adjacent slots (one binary search for its first unit, then
//      the set bits in order), and each writes ei_term of its pairs;
//   4. add: the owner of column c (thread c) adds its units' terms chunk
//      by chunk, bits ascending: ascending tenant order, ei_total_column's
//      float32 sum bit for bit.
// With disjoint membership a slab is a few ballots and at most one term a
// column; with dense membership the terms (erf or erfc, and exp, in double)
// are spread over every thread of the block.

constexpr int kTileThreads = 256;                // threads a block
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kSlabUnits = kTileThreads;         // (chunk, column) units a slab
// Columns a block: each membership row is read in 32-byte runs, a whole
// sector.  The Fig-5 episode's n 2,500 gives 79 blocks and device churn's
// n 4,096 gives 128, fewer than the 132 SMs; still 16-column tiles (157
// and 256 blocks) made those paths' kernels 4% and 9% slower alone
// (tools/ei_tiles.py, PERF.md §6).
constexpr int kTileCols = 32;

struct TileScratch {
  static constexpr int kChunks = kSlabUnits / kTileCols;  // 32-tenant chunks a slab
  static constexpr int kTenants = 32 * kChunks;
  float terms[kTenants * kTileCols];       // a slab's member terms, by slot
  float best[kTenants];                    // the slab's best_i
  unsigned mask[kSlabUnits];               // unit u = chunk * kTileCols + column
  int off[kSlabUnits + 1];                 // unit u's first slot; off[U] = P
  int warp_sum[kTileWarps];
  float m[kTileCols], safe[kTileCols];
  bool positive[kTileCols];
};

// The kTileCols membership bytes of row i from column x0 on, zero past n,
// as kTileCols / 16 vectors.  kVec 16: n and the base are multiples of 16;
// kVec 4: of 4; kVec 1: any.
template <int kVec>
__device__ __forceinline__ void load_tile_row(
    const unsigned char* __restrict__ membership, int n, int i, int x0,
    uint4 (&v)[kTileCols / 16]) {
  const unsigned char* row = membership + static_cast<size_t>(i) * n + x0;
#pragma unroll
  for (int h = 0; h < kTileCols / 16; ++h) {
    const int xh = x0 + 16 * h;
    if (kVec == 16) {
      v[h] = xh < n ? __ldg(reinterpret_cast<const uint4*>(row) + h)
                    : make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if (kVec == 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (xh + 4 * j < n)
          w[j] = __ldg(reinterpret_cast<const unsigned*>(row) + 4 * h + j);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (xh + j < n)
          w[j >> 2] |= static_cast<unsigned>(__ldg(row + 16 * h + j))
                       << (8 * (j & 3));
    }
    v[h] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The tenant sums of columns x0 .. x0 + kTileCols - 1 (those < n); every
// thread of the block must call it.  Returns column t's total in thread t
// (t < kTileCols), 0 elsewhere.
template <int kVec>
__device__ __forceinline__ float tile_totals(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ best,
    const unsigned char* __restrict__ membership, int N, int n, int x0,
    TileScratch& s) {
  constexpr int kCols = kTileCols;
  constexpr int kChunks = TileScratch::kChunks;
  constexpr int kTenants = TileScratch::kTenants;
  constexpr int kRows = (kChunks + kTileWarps - 1) / kTileWarps;  // a lane
  static_assert(kCols % 16 == 0 && kCols <= 32, "a lane keeps one mask");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < kCols) {
    const bool live = x0 + t < n;
    const float sg = live ? sigma[x0 + t] : 0.0f;
    s.m[t] = live ? mu[x0 + t] : 0.0f;
    s.positive[t] = sg > 0.0f;
    s.safe[t] = sg > 0.0f ? sg : 1.0f;
  }
  // a lane's rows and best_i of a slab: chunk warp + j * kTileWarps
  uint4 rows[kRows][kCols / 16];
  float bests[kRows];
  auto load_slab = [&](int i0) {
    const int K = min(kChunks, (N - i0 + 31) / 32);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = warp + j * kTileWarps, i = i0 + 32 * k + lane;
      const bool live = k < K && i < N;
#pragma unroll
      for (int h = 0; h < kCols / 16; ++h) rows[j][h] = make_uint4(0u, 0u, 0u, 0u);
      if (live) load_tile_row<kVec>(membership, n, i, x0, rows[j]);
      bests[j] = live ? __ldg(best + i) : 0.0f;
    }
  };
  float total = 0.0f;
  if (N > 0) load_slab(0);
  for (int i0 = 0; i0 < N; i0 += kTenants) {
    const int K = min(kChunks, (N - i0 + 31) / 32);    // the slab's chunks
    const int U = K * kCols;                            // and units

    // 1. ballot each chunk per column, then issue the next slab's loads
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = warp + j * kTileWarps;
      if (k >= K) continue;                             // warp-uniform
      s.best[32 * k + lane] = bests[j];
      unsigned mine = 0u;                  // lane c's: column c's mask
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint4& v = rows[j][c >> 4];
        const unsigned word = (c & 15) < 4 ? v.x : (c & 15) < 8 ? v.y
                              : (c & 15) < 12 ? v.z : v.w;
        const unsigned b =
            __ballot_sync(0xffffffffu, (word >> (8 * (c & 3))) & 0xffu);
        if (c == lane) mine = b;
      }
      if (lane < kCols) s.mask[k * kCols + lane] = mine;
    }
    if (i0 + kTenants < N) load_slab(i0 + kTenants);
    __syncthreads();

    // 2. exclusive scan of the units' member counts
    const int cnt = t < U ? __popc(s.mask[t]) : 0;
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) s.warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, P = 0;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      before += w < warp ? s.warp_sum[w] : 0;
      P += s.warp_sum[w];
    }
    s.off[t] = before + incl - cnt;        // = P for every t >= U
    if (t == 0) s.off[kSlabUnits] = P;
    __syncthreads();

    // 3. the member terms: thread t takes slots [t q, t q + q) of P
    const int q = (P + kTileThreads - 1) / kTileThreads;
    int p = t * q;
    const int p_end = min(p + q, P);
    if (p < p_end) {
      int lo = 0, hi = U;                  // off[lo] <= p < off[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s.off[mid] <= p) lo = mid; else hi = mid;
      }
      int u = lo;
      unsigned m = s.mask[u];
      for (int r = p - s.off[u]; r > 0; --r) m &= m - 1u;
      for (; p < p_end; ++p) {             // one pair an iteration, so a
        while (m == 0u) m = s.mask[++u];   // warp's lanes stay in step
        const int c = u % kCols, bit = __ffs(m) - 1;
        m &= m - 1u;
        s.terms[p] = ei_term(s.m[c], s.safe[c], s.positive[c],
                             s.best[32 * (u / kCols) + bit]);
      }
    }
    __syncthreads();

    // 4. each column's owner adds its terms in ascending tenant order
    if (t < kCols) {
      for (int k = 0; k < K; ++k) {
        const int u = k * kCols + t, e_end = s.off[u + 1];
        for (int e = s.off[u]; e < e_end; ++e) total = total + s.terms[e];
      }
    }
    // the next slab's step 1 writes best and mask, which step 4 does not
    // read; its scan writes off after a barrier every owner has passed
  }
  return total;
}

// The row load of a launch: kVec-byte loads.
template <int V>
struct RowLoad {
  static constexpr int kVec = V;
};

// Calls launch(RowLoad<kVec>{}) for the widest row load that n and the
// base of membership allow.  At the Fig-5 episode's n 2,500 (not a
// multiple of 16) 4-byte loads took 21-28% less time alone than byte
// loads (tools/ei_tiles.py, PERF.md §6).
template <class Launch>
__host__ inline void tile_dispatch(const unsigned char* membership, int n,
                                   Launch&& launch) {
  const auto base = reinterpret_cast<uintptr_t>(membership);
  if (n % 16 == 0 && base % 16 == 0) launch(RowLoad<16>{});
  else if (n % 4 == 0 && base % 4 == 0) launch(RowLoad<4>{});
  else launch(RowLoad<1>{});
}

}  // namespace ei
