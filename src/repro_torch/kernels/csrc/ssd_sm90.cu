// Mamba2 SSD chunk scan, bf16 x, B and C, for Hopper, sm_90a: the chunk
// products on the tensor cores through wgmma, tiles copied by TMA.
//
// Replaces: src/repro/kernels/ssd.py, ssd_pallas (pallas_call at line 92;
// body _ssd_kernel), for bf16 x, B and C.  Float32 inputs take the
// CUDA-core kernel of ssd.cu; the wrapper (kernels/ssd.py) chooses by dtype.
//
// The chunked SSD of arXiv:2405.21060 section 6, with lcum the inclusive
// cumsum of log_a within a chunk of Q steps and l_end its last value:
//
//   states  S_c[p, n]  = sum_s x_s[p] B'_s[n],  B'_s = exp(l_end - lcum_s) dt_s B_s
//   pass    in_0 = 0,  in_{c+1} = exp(l_end_c) in_c + S_c        (float32)
//   outputs y_t[p] = exp(lcum_t) (C_t . in_c[p, :]) + sum_{s <= t} W'[t, s] x_s[p]
//           W'[t, s] = (C_t . B_s) exp(lcum_t - lcum_s) dt_s
//
// y (B, S, H, P) float32, without the D * x skip term.  Three launches a
// call (two when the sequence is one chunk: no state is carried):
// ssd_chunk_state_kernel (lcum of every chunk, the state of every chunk but
// the last), ssd_state_pass_kernel (the short sequential pass over the
// chunks, which writes each entering state as the outputs' bf16 hi and lo
// operand tiles), ssd_chunk_out_kernel (the outputs).  Units of work:
// (batch, head, chunk) for the states, (batch, head, chunk, 64-row slab)
// for the outputs, all independent.
//
// Precision.  x, B and C are bf16 and enter the products exactly.  What
// carries dt and the decays is float32: B', W' and the carried state.  Each
// of those is split into bf16 hi = bf16(v) and lo = bf16(v - hi), and each
// product runs twice, on hi and on lo, into the same float32 accumulators,
// so every term keeps about 16 significant bits (a single bf16 rounding,
// 2^-9, would not meet the float32 tolerance the kernel is held to).  C B^T
// is exact in its products.
//
// Bound on an H100: at mamba2-1.3b's layer (B 4, S 2,048, H 64, P 64, N 128,
// Q 256) x is read twice, y written once, and the chunk states written,
// passed and read (about 0.5 GB, 0.15 ms at 3.35 TB/s); the products,
// hi and lo, with C B^T taken again for every head, are about 70 GFLOP
// (0.07 ms at the bf16 tensor-core rate).  Bound by bytes.
//
// Design:
// - TMA (4-d maps over (P, S, H, B) for x and (N, S, 1, B) for B and C, the
//   views' own strides) copies 64-step tiles into 128-byte swizzled boxes
//   of 64 columns; P and N are the maps' inner extents, so columns past
//   them are zero-filled, and so are steps past S.  Steps of a 64-step slab
//   that lie past the chunk's end get a zero weight (B'), or are masked
//   (W': s <= t), so a short chunk never reads its neighbour's terms.
// - states: one warpgroup per 64 rows of P.  Threads form B'_hi and B'_lo
//   from the TMA-copied B tile, at the same swizzled offsets, behind a
//   proxy fence; then S += X^T B'_hi + X^T B'_lo (wgmma m64nNk16, X^T the
//   MN-major A operand, B' the N-major B operand, both from shared memory).
// - pass: the state entering each chunk is split once, by the pass, into
//   the hi and lo tiles the outputs' wgmma reads (K-major, swizzled), so an
//   output block takes them with one bulk copy and no thread work.
// - outputs: one warpgroup per (64-row slab of a chunk); C's slab stays in
//   shared memory.  y starts as C in_hi^T + C in_lo^T (wgmma), scaled by
//   exp(lcum_t); then for each 64-step slab s <= t: G = C B^T (wgmma, both
//   K-major), W' formed on the accumulators (the decay as one MUFU.EX2, dt
//   and the causal mask; the slab's lcum and dt staged
//   in shared memory a step ahead), split hi/lo into register A fragments
//   (the accumulator layout of a k16 slice is the A layout), and
//   y += W'_hi X + W'_lo X (X the N-major B operand).  C B^T is taken again
//   for every head: about 22 GFLOP at the main shape, 22 us at the
//   tensor-core rate, against a (B, nc, Q, Q) buffer's round trip.
// - a ring of two stages on mbarriers streams the slabs; a block waits for
//   each product (no warp specialisation: several blocks share an SM).
// Shapes: P <= 128 (PP = 64 or 128), N <= 128 (NP = 64 or 128), any Q and S.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSlab = 64;          // steps of a slab, rows of an output slab
constexpr int kBox = 64 * 128;     // bytes of a 64-row box of 64 bf16 columns
constexpr int kOutThreads = 128;   // one warpgroup
constexpr int kPassThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// ---- shared pieces ------------------------------------------------------------------

// slab [s0, s0 + 64) of x (PP / 64 boxes, head h) and of B (NP / 64 boxes)
// into a stage (x first), completion on `bar`
template <int PP, int NP>
__device__ __forceinline__ void issue_slab(uint32_t stage, uint32_t bar,
                                           const CUtensorMap* tx, const CUtensorMap* tb,
                                           int s0, int h, int b) {
  mbar_expect_tx(bar, (PP + NP) * 128);
  for (int k = 0; k < PP / 64; ++k) tma_load(stage + k * kBox, tx, bar, 64 * k, s0, h, b);
  for (int k = 0; k < NP / 64; ++k)
    tma_load(stage + PP * 128 + k * kBox, tb, bar, 64 * k, s0, 0, b);
}

struct Dims {
  int S, H, P, N, Q, nc;
  long long dsb, dss, dsh;   // dt strides (batch, step, head), elements
  long long lsb, lss, lsh;   // log_a strides
};

// lcum (B, H, S) of the chunk [c0, c0 + L), by warp 0, 256 steps at a time
// (their loads issued together); returns l_end on every lane of warp 0
__device__ __forceinline__ float chunk_cumsum(const float* la, float* lcum, int c0,
                                              int L, long long lss, int lane) {
  float carry = 0.0f;
  for (int s0 = 0; s0 < L; s0 += 256) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = s0 + 32 * k + lane;
      v[k] = s < L ? la[(c0 + s) * lss] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v[k], off);
        if (lane >= off) v[k] += u;
      }
      v[k] += carry;
      const int s = s0 + 32 * k + lane;
      if (s < L) lcum[c0 + s] = v[k];
      carry = __shfl_sync(0xffffffffu, v[k], 31);
    }
  }
  return carry;
}

// ---- 1. chunk states ----------------------------------------------------------------

template <int PP, int NP>
struct StateLayout {
  static constexpr int kX = PP * 128;    // PP / 64 boxes of 64 steps
  static constexpr int kB = NP * 128;    // NP / 64 boxes of 64 steps
  static constexpr int kStage = kX + kB;
  // + 1,024 to align the tiles to the swizzle pattern's 1,024 bytes; B'_hi
  // takes the place of its stage's B tile, B'_lo a tile of its own
  static constexpr int kSmem = 1024 + 2 * kStage + kB + 4 * kSlab + 8 * 2;
};

// one block per (chunk c < nc - 1 or the last, head, batch): lcum of the
// chunk; for every chunk but the last, S_c (P x N) float32 into
// states[b, h, c].  PP / 64 warpgroups, one per 64 rows of P.
template <int PP, int NP>
__global__ void __launch_bounds__(2 * PP, 1)
ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tb,
                       const float* __restrict__ dt, const float* __restrict__ la,
                       float* lcum, float* __restrict__ states, Dims d) {
  using L_ = StateLayout<PP, NP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bp_lo = ring + 2 * L_::kStage;
  unsigned char* base = smem_raw + (ring - smem_u32(smem_raw));
  float* w = reinterpret_cast<float*>(base + 2 * L_::kStage + L_::kB);
  const uint32_t bars = smem_u32(w + kSlab);
  auto full = [&](int st) { return bars + 8 * st; };

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0);
  const int nslab = (L + kSlab - 1) / kSlab;
  const bool carry = c < d.nc - 1;
  const int tid = threadIdx.x, lane = tid & 31;
  constexpr int kThreads = 2 * PP;

  if (tid == 0) {
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && carry) {
    issue_slab<PP, NP>(ring, full(0), &tx, &tb, c0, h, b);
    if (nslab > 1)
      issue_slab<PP, NP>(ring + L_::kStage, full(1), &tx, &tb, c0 + kSlab, h, b);
  }
  float* lc = lcum + (static_cast<long long>(b) * d.H + h) * d.S;
  __shared__ float l_end_s;
  if (tid < 32) {
    const float e = chunk_cumsum(la + b * d.lsb + h * d.lsh, lc, c0, L, d.lss, lane);
    if (lane == 0) l_end_s = e;
  }
  __syncthreads();
  if (!carry) return;
  const float l_end = l_end_s;
  const float* dtc = dt + b * d.dsb + h * d.dsh;

  const int g = tid / 128, t = tid & 127, wp = t >> 5;
  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;

  for (int j = 0; j < nslab; ++j) {
    const int st = j & 1, s0 = c0 + j * kSlab;
    if (tid < kSlab) {   // B' weight of each step of the slab, 0 past the chunk
      const int s = s0 + tid;
      w[tid] = s < c0 + L ? expf(l_end - lc[s]) * dtc[s * d.dss] : 0.0f;
    }
    mbar_wait(full(st), (j >> 1) & 1);
    __syncthreads();
    // B'_hi over the B tile, B'_lo at the same (swizzled) offsets of its
    // own tile: a 16-byte chunk holds 8 columns of one step
    unsigned char* braw = base + st * L_::kStage + L_::kX;
    for (int idx = tid; idx < NP / 64 * 512; idx += kThreads) {
      const int row = (idx & 511) >> 3;
      const uint4 raw = *reinterpret_cast<const uint4*>(braw + 16 * idx);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float ws = w[row];
      uint4 hi, lo;
      uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(v[k]);
        split_bf16(ws * f.x, ws * f.y, hp[k], lp[k]);
      }
      *reinterpret_cast<uint4*>(braw + 16 * idx) = hi;
      *reinterpret_cast<uint4*>(base + 2 * L_::kStage + 16 * idx) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t xg = ring + st * L_::kStage + g * kBox;   // this warpgroup's 64 rows of P
    const uint32_t bp_hi = ring + st * L_::kStage + L_::kX;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk) {
      const uint64_t da = sw128_desc(xg + kk * 16 * 128, kBox, 1024);
      wgmma_ss<NP, 1, 1>(acc, da, sw128_desc(bp_hi + kk * 16 * 128, kBox, 1024), 1);
      wgmma_ss<NP, 1, 1>(acc, da, sw128_desc(bp_lo + kk * 16 * 128, kBox, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();   // stage st and the B'_lo tile are free again
    if (tid == 0 && j + 2 < nslab)
      issue_slab<PP, NP>(ring + st * L_::kStage, full(st), &tx, &tb, s0 + 2 * kSlab, h, b);
  }

  // acc (64 rows of P x NP) -> states[b, h, c] (P x N)
  float* out = states + ((static_cast<long long>(b) * d.H + h) * (d.nc - 1) + c) *
                            static_cast<long long>(d.P) * d.N;
  const int p0 = 64 * g + 16 * wp + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) {
    const int p = p0 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + col + (i & 1);
    if (p < d.P && n < d.N) out[p * d.N + n] = acc[i];
  }
}

// ---- 2. the pass over the chunks ----------------------------------------------------

// The state entering chunk c + 1, in_1 = S_0, in_{c+1} = exp(l_end_c) in_c +
// S_c, written as its bf16 hi and lo tiles in the layout of the outputs'
// B operand: tiles[b, h, c] = hi then lo, each PP x NP bf16 K-major (rows p,
// columns n in 128-byte swizzled boxes of 64), zero past P and N, so that an
// output block copies them into shared memory as they are.  One thread per
// (b, h, p, n) of the padded tile, walking the chunks in order.
template <int PP, int NP>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ lcum, const float* __restrict__ states,
                      __nv_bfloat16* __restrict__ tiles, Dims d) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PP * NP) return;
  const int p = e / NP, n = e % NP;
  const bool live = p < d.P && n < d.N;
  const long long PN = static_cast<long long>(d.P) * d.N;
  const long long bh = static_cast<long long>(b) * d.H + h;
  const float* lc = lcum + bh * d.S;
  const float* st = states + bh * (d.nc - 1) * PN + (live ? p * d.N + n : 0);
  // this element's byte offset in a tile
  const int off = (n / 64) * PP * 128 + p * 128 + ((((n & 63) >> 3) ^ (p & 7)) << 4) +
                  2 * (n & 7);
  unsigned char* out = reinterpret_cast<unsigned char*>(tiles) +
                       bh * (d.nc - 1) * (4LL * PP * NP) + off;
  float run = 0.0f;
  for (int c = 0; c < d.nc - 1; ++c) {
    const float decay = expf(lc[(c + 1) * d.Q - 1]);
    run = decay * run + (live ? st[c * PN] : 0.0f);
    const __nv_bfloat16 hi = __float2bfloat16_rn(run);
    const __nv_bfloat16 lo = __float2bfloat16_rn(run - __bfloat162float(hi));
    unsigned char* t = out + c * (4LL * PP * NP);
    *reinterpret_cast<__nv_bfloat16*>(t) = hi;
    *reinterpret_cast<__nv_bfloat16*>(t + 2 * PP * NP) = lo;
  }
}

// ---- 3. outputs ---------------------------------------------------------------------

template <int PP, int NP>
struct OutLayout {
  static constexpr int kC = NP * 128;          // NP / 64 boxes of 64 rows
  static constexpr int kState = PP * NP * 2;   // NP / 64 boxes of PP rows
  static constexpr int kX = PP * 128;
  static constexpr int kB = NP * 128;
  static constexpr int kStage = kX + kB;
  // ring stage 1 takes the state tiles' space once the inter product is done
  static constexpr int kShared = 2 * kState > kStage ? 2 * kState : kStage;
  // + lcum and dt of the slab, two buffers
  static constexpr int kSmem = 1024 + kC + kShared + kStage + 4 * 4 * 64 + 8 * 3;
};

// one block (one warpgroup) per (64-row slab i of chunk c, head, batch):
// y[b, t, h, :] for the slab's rows t
template <int PP, int NP>
__global__ void __launch_bounds__(kOutThreads)
ssd_chunk_out_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const float* __restrict__ dt, const float* __restrict__ lcum,
                     const __nv_bfloat16* __restrict__ tiles, float* __restrict__ y,
                     Dims d) {
  using L_ = OutLayout<PP, NP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sc = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t st_hi = sc + L_::kC;              // the state tiles, then stage 1
  const uint32_t st_lo = st_hi + L_::kState;
  const uint32_t stage0 = st_hi + L_::kShared;
  auto stage = [&](int st) { return st == 0 ? stage0 : st_hi; };
  unsigned char* base = smem_raw + (sc - smem_u32(smem_raw));
  float* cols = reinterpret_cast<float*>(base + (stage0 - sc) + L_::kStage);
  const uint32_t bars = smem_u32(cols + 4 * 64);
  const uint32_t full_c = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };

  const int ts = (d.Q + kSlab - 1) / kSlab;
  const int i = ts - 1 - static_cast<int>(blockIdx.x) / d.nc;   // heaviest slabs first
  const int c = static_cast<int>(blockIdx.x) % d.nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.Q, L = min(d.Q, d.S - c0);
  if (i * kSlab >= L) return;
  const int t0 = c0 + i * kSlab;
  const int t_end = c0 + L;   // rows past it belong to the next chunk or past S
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int ksteps = (d.N + 15) / 16;

  if (tid == 0) {
    mbar_init(full_c, 1);
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long bh = static_cast<long long>(b) * d.H + h;
  if (tid == 0) {
    // C's slab and, past the first chunk, the entering state's hi and lo
    // tiles as the pass wrote them
    mbar_expect_tx(full_c, L_::kC + (c > 0 ? 2 * L_::kState : 0));
    for (int k = 0; k < NP / 64; ++k) tma_load(sc + k * kBox, &tc, full_c, 64 * k, t0, 0, b);
    if (c > 0)
      bulk_load(st_hi, tiles + (bh * (d.nc - 1) + c - 1) * (2LL * PP * NP),
                2 * L_::kState, full_c);
    issue_slab<PP, NP>(stage0, full(0), &tx, &tb, c0, h, b);
    if (i > 0 && c == 0) issue_slab<PP, NP>(st_hi, full(1), &tx, &tb, c0 + kSlab, h, b);
  }

  const float* lc = lcum + bh * d.S;
  const float* dtc = dt + b * d.dsb + h * d.dsh;
  const int ta = t0 + 16 * wp + (lane >> 2), tb_ = ta + 8;   // this thread's rows
  const int col = 2 * (lane & 3);                           // + 8 j + (k & 1)
  const float lta = ta < d.S ? lc[ta] : 0.0f, ltb = tb_ < d.S ? lc[tb_] : 0.0f;
  // lcum and dt of slab j's 64 steps, into buffer j % 2
  auto load_cols = [&](int j) {
    if (tid < kSlab) {
      const int s = c0 + j * kSlab + tid;
      cols[(j & 1) * 128 + tid] = s < d.S ? lc[s] : 0.0f;
      cols[(j & 1) * 128 + 64 + tid] = s < d.S ? dtc[s * d.dss] : 0.0f;
    }
  };
  load_cols(0);

  float acc[PP / 2];
#pragma unroll
  for (int k = 0; k < PP / 2; ++k) acc[k] = 0.0f;

  if (c > 0) {
    mbar_wait(full_c, 0);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      if (kk < ksteps) {
        const uint64_t da = sw128_desc(sc + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        const uint32_t so = (kk / 4) * PP * 128 + (kk % 4) * 32;
        wgmma_ss<PP, 0, 0>(acc, da, sw128_desc(st_hi + so, 16, 1024), 1);
        wgmma_ss<PP, 0, 0>(acc, da, sw128_desc(st_lo + so, 16, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // the state tiles are read: slab 1 may land on them
    if (tid == 0 && i > 0) issue_slab<PP, NP>(st_hi, full(1), &tx, &tb, c0 + kSlab, h, b);
    const float ea = expf(lta), eb = expf(ltb);
#pragma unroll
    for (int k = 0; k < PP / 2; ++k) acc[k] *= (k & 2) ? eb : ea;
  } else {
    mbar_wait(full_c, 0);
  }
  __syncthreads();   // slab 0's columns

  for (int j = 0; j <= i; ++j) {
    const int st = j & 1, s0 = c0 + j * kSlab;
    const float* ls = cols + st * 128;   // this slab's lcum and dt
    const float* ds = ls + 64;
    if (j < i) load_cols(j + 1);         // published by the barrier ending this step
    mbar_wait(full(st), (j >> 1) & 1);
    const uint32_t xs = stage(st), bs = xs + L_::kX;
    float g[32];
    fence_regs(g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      if (kk < ksteps) {
        const uint64_t da = sw128_desc(sc + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        const uint64_t db = sw128_desc(bs + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        wgmma_ss<64, 0, 0>(g, da, db, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(g);
    // W' = (G exp(lcum_t - lcum_s)) dt_s where s <= t, 0 elsewhere, the
    // decay as 2^((lcum_t - lcum_s) log2 e); hi + lo
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float wv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * kk + 2 * r + e;              // g[k]
          const int q = 8 * (k >> 2) + col + (k & 1);    // its column in the slab
          const int row = (k & 2) ? tb_ : ta;
          const float lt = (k & 2) ? ltb : lta;
          wv[e] = (j < i || s0 + q <= row) ? g[k] * ex2((lt - ls[q]) * kLog2e) * ds[q]
                                           : 0.0f;
        }
        split_bf16(wv[0], wv[1], a_hi[kk][r], a_lo[kk][r]);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = sw128_desc(xs + kk * 16 * 128, kBox, 1024);
      wgmma_rs<PP>(acc, a_hi[kk], dx, 1);
      wgmma_rs<PP>(acc, a_lo[kk], dx, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();   // stage st is free again
    if (tid == 0 && j + 2 <= i)
      issue_slab<PP, NP>(stage(st), full(st), &tx, &tb, s0 + 2 * kSlab, h, b);
  }

  // y[b, t, h, p] for the slab's rows of the chunk
  const long long ys = static_cast<long long>(d.H) * d.P;
#pragma unroll
  for (int k = 0; k < PP / 2; ++k) {
    const int t = (k & 2) ? tb_ : ta;
    const int p = 8 * (k >> 2) + col + (k & 1);
    if (t < t_end && p < d.P)
      y[(static_cast<long long>(b) * d.S + t) * ys + static_cast<long long>(h) * d.P + p] =
          acc[k];
  }
}
template <int PP, int NP>
int launch(const void* x, const float* dt, const float* la, const void* bm,
           const void* cm, float* y, float* lcum, float* states, void* tiles, int B,
           const Dims& d, const long long* st, cudaStream_t stream) {
  CUtensorMap tx, tb, tc;
  int err = make_map(&tx, x, B, d.S, d.H, d.P, st[0], st[1], st[2], kSlab);
  if (err == 0) err = make_map(&tb, bm, B, d.S, 1, d.N, st[3], st[4], 8, kSlab);
  if (err == 0) err = make_map(&tc, cm, B, d.S, 1, d.N, st[5], st[6], 8, kSlab);
  if (err != 0) return err;

  auto k1 = ssd_chunk_state_kernel<PP, NP>;
  constexpr int smem1 = StateLayout<PP, NP>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  k1<<<dim3(d.nc, d.H, B), 2 * PP, smem1, stream>>>(tx, tb, dt, la, lcum, states, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto* t = static_cast<__nv_bfloat16*>(tiles);
  if (d.nc > 1) {
    const int blocks = (PP * NP + kPassThreads - 1) / kPassThreads;
    ssd_state_pass_kernel<PP, NP><<<dim3(blocks, d.H, B), kPassThreads, 0, stream>>>(
        lcum, states, t, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  auto k3 = ssd_chunk_out_kernel<PP, NP>;
  constexpr int smem3 = OutLayout<PP, NP>::kSmem;
  e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ts = (d.Q + kSlab - 1) / kSlab;
  k3<<<dim3(ts * d.nc, d.H, B), kOutThreads, smem3, stream>>>(tx, tb, tc, dt, lcum, t,
                                                              y, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 x (B, S, H, P), B and C (B, S, N); float32 dt and log_a (B, S, H);
// y (B, S, H, P) float32, contiguous.  Scratch: lcum (B, H, S) float32,
// states (B, H, nc - 1, P, N) float32 and tiles (B, H, nc - 1, 4 PP NP)
// bytes, 16-byte aligned, nc = ceil(S / Q), PP and NP = P and N rounded up to
// 64 or 128.  P <= 128, N <= 128,
// S >= 1, 1 <= Q (the wrapper checks them).  Strides in elements: x (b, s, h),
// B (b, s), C (b, s), dt (b, s, h), log_a (b, s, h); the bases and the
// strides of x, B and C 16-byte aligned.  Returns 0, a cudaError_t, or
// 10000 (misaligned), 10001 (no cuTensorMapEncodeTiled), 10002 + CUresult
// (map refused).
extern "C" int ssd_sm90_launch(const void* x, const float* dt, const float* la,
                               const void* bm, const void* cm, float* y, float* lcum,
                               float* states, void* tiles, int B, int S, int H, int P,
                               int N, int Q,
                               long long xb, long long xs, long long xh, long long bb,
                               long long bs, long long cb, long long cs, long long db,
                               long long ds, long long dh, long long lb, long long ls,
                               long long lh, void* stream) {
  Dims d{S, H, P, N, Q, (S + Q - 1) / Q, db, ds, dh, lb, ls, lh};
  const long long st[7] = {xb, xs, xh, bb, bs, cb, cs};
  auto s = static_cast<cudaStream_t>(stream);
  if (P <= 64) {
    if (N <= 64) return launch<64, 64>(x, dt, la, bm, cm, y, lcum, states, tiles, B, d, st, s);
    return launch<64, 128>(x, dt, la, bm, cm, y, lcum, states, tiles, B, d, st, s);
  }
  if (N <= 64) return launch<128, 64>(x, dt, la, bm, cm, y, lcum, states, tiles, B, d, st, s);
  return launch<128, 128>(x, dt, la, bm, cm, y, lcum, states, tiles, B, d, st, s);
}
