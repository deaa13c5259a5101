// Mamba2 SSD chunk scan, float32 x, B and C, for Hopper, sm_90a: the chunk
// products on the tensor cores through tf32 wgmma, each float32 product
// taken as three TF32 products (3xTF32), so the route keeps float32
// accuracy.
//
// Replaces: src/repro/kernels/ssd.py, ssd_pallas (pallas_call at line 92;
// body _ssd_kernel), for float32 x, B and C.  bf16 inputs take
// ssd_sm90.cu; the wrapper (kernels/ssd.py) chooses by dtype.
//
// The chunked SSD of arXiv:2405.21060 section 6, with lcum the inclusive
// cumsum of log_a within a chunk of Q steps and l_end its last value:
//
//   states  S_c[p, n]  = sum_s w_s x_s[p] B_s[n],  w_s = exp(l_end - lcum_s) dt_s
//   pass    in_0 = 0,  in_{c+1} = exp(l_end_c) in_c + S_c        (float32)
//   outputs y_t[p] = exp(lcum_t) (C_t . in_c[p, :]) + sum_{s <= t} W'[t, s] x_s[p]
//           W'[t, s] = G[t, s] exp(lcum_t - lcum_s) dt_s,  G = C B^T
//
// y (B, S, H, P) float32, without the D * x skip term.  Four launches a
// call, each unit of work independent:
//   ssd_tf32x3_state_kernel  (batch, two heads, chunk but the last, 64 rows
//                            of P): S_c and l_end_c
//   ssd_tf32x3_pass_kernel   (batch, head, element of the state): the short
//                            float32 pass over the chunks, which writes each
//                            entering state once as tf32 hi and lo operand
//                            tiles
//   ssd_tf32x3_chunk_kernel  (batch, chunk, 64-row slab i, group of 8
//                            heads): G_ij = C_i B_j^T for j <= i, once for all
//                            heads, into a scratch of G tiles; and y = exp(
//                            lcum_t) C in^T for each head of the group
//   ssd_tf32x3_out_kernel    (batch, head, chunk, slab i, 64 columns of P):
//                            y += W' X, W' formed from the G tiles
// A sequence of one chunk carries no state: the chunk kernel (G alone) and
// the outputs run.
//
// Arithmetic: every float32 factor v of the four products (C B^T, W' X,
// C in^T, (w X)^T B) enters as hi = tf32(v) and lo = tf32(v - hi), both
// rounded to nearest, ties away from zero (the tensor core would truncate),
// and a product a b as a_hi b_lo + a_lo b_hi + a_hi b_hi with float32
// accumulation.  hi + lo keeps about 21 significant bits and the dropped
// a_lo b_lo is below 2^-21 of the product, so the route holds to the
// float32 oracle where one TF32 product (2^-11) would not.  Every lcum
// comes from one chain (`chain`: a slab's local warp scan plus the sum of
// the chunk's earlier slab totals in order), so the kernels agree on it to
// the bit.  ref.ssd_tf32x3_route_ref is this arithmetic chunk for chunk.
//
// Bound on an H100: at mamba2-1.3b's layer shape, B 2 (S 2,048, H 64, P 64,
// N 128, Q 256), the chunked algorithm does about 13.2 GFLOP (C B^T once per
// (batch, chunk)); as three TF32 products each, 39.5 GFLOP over the TF32
// tensor-core rate (495 TFLOP/s) is 0.080 ms, against 0.042 ms for its
// bytes: bound by operations.  The G tiles and the entering states' tiles
// are scratch of their own (2.6 MB and 59 MB at that shape, written once;
// G read by every head, an entering state by the 4 slabs of its chunk).
//
// Design:
// - every operand is K-major in 128-byte swizzled rows of 32 values (tf32
//   wgmma takes no transpose): C and B as they come (N contiguous) for G,
//   the entering state as the pass wrote it for C in^T; x transposed while
//   it is split, for the states' (w X)^T B (with B transposed too) and the
//   outputs' W' X (K = steps).
// - every float32 value passes through a thread to be split, so raw 64-step
//   tiles are copied by cp.async (16-byte copies where the bases, strides,
//   P and N allow, else 4-byte ones: any view of a fused projection) while
//   the tensor cores work, then split; C and B, whose operands keep their
//   rows, are staged raw in their lo tiles at each value's own position and
//   split there.  Steps past the chunk's end and columns past P and N are
//   zeros.
// - states: two warpgroups, one a head (one warpgroup idles on the last
//   head of an odd H); B^T is split once for both, each head's x scaled by
//   its own w_s while it is split; S += (w X)^T B^T (wgmma m64nNPk8).
// - chunk products: C's slab split once; each second operand (B's slab j,
//   a head's entering state) copied into one of two buffers while the last
//   product runs; G tiles stored in the accumulators' order, so that an
//   output thread reads its own fragment with 16-byte loads.
// - outputs: one warpgroup, three blocks a SM (52 KB of shared memory, at
//   most 170 registers): the next slab's x is copied while a block works,
//   and the other blocks of its SM fill its waits.  y starts as the chunk
//   kernel's C in^T, read into the accumulators in the prologue; then for
//   each 64-step slab s <= t: x split into X^T, W' formed on the G
//   fragment (16-byte loads) with the decay by ex2, dt and the causal mask,
//   split into hi and lo A fragments in registers, and y += W' X (wgmma
//   m64n64k8, A from registers).  A thread's accumulator holds steps 2t and
//   2t + 1 of a k8 slice where tf32's A fragment wants t and t + 4, so X^T
//   is stored with each group of 8 steps in the order 0 2 4 6 1 3 5 7 (as
//   flash_attention.cu stores V): the accumulator pairs are the fragment,
//   and a sum over steps does not care about their order (the states'
//   product reads both operands in that order, which leaves it unchanged
//   too).  One warp takes the lcum chain and loads the next slab's log_a
//   and dt a slab ahead.
// Shapes: P <= 128 (one or two 64-column halves), N <= 128 (NP = 64 or
// 128, the k8 steps past N skipped), any Q and S; the G scratch grows as
// ceil(S / Q) ceil(Q / 64)^2 / 2 tiles of 16 KB a batch row.  Shared memory
// (NP 128): states 198,160 bytes, chunk products 199,680, outputs 50,944.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSlab = 64;          // steps of a slab, rows of an output slab, columns of P
constexpr int kThreads = 128;      // one warpgroup a block (states, outputs)
constexpr int kPassThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int S, H, P, N, Q, nc, vec;
  long long xb, xs, xh;   // x strides (batch, step, head), elements
  long long bb, bs;       // B strides (batch, step)
  long long cb, cs;       // C strides
  long long db, ds, dh;   // dt strides
  long long lb, ls, lh;   // log_a strides
};

// byte offset of the 16-byte unit u (values 4u .. 4u + 3 of K) of row r in
// a K-major operand of `rows` rows: boxes of 32 values, 128-byte swizzle
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int u) {
  return (u >> 3) * rows * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

// hi = tf32(v), lo = tf32(v - hi), both rounded to nearest, ties away from
// zero, as split_tf32 gives them: hi as 2^12 added to the bit pattern and
// the low 13 bits cleared, two instructions where cvt.rna.tf32.f32 takes
// four (it also tests for NaN), the same bits for every finite v and for
// infinities; lo by cvt.rna, so that a NaN v (whose hi this rounding may
// wrap to 0) reaches the products as a NaN lo.
__device__ __forceinline__ void split32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo,
                                            uint32_t off, float4 v) {
  uint4 h, l;
  split32(v.x, h.x, l.x);
  split32(v.y, h.y, l.y);
  split32(v.z, h.z, l.z);
  split32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// rows [row0, row0 + 64) of a (step, column) view (base: its row 0, column
// 0; rs its row stride) by cp.async, zeros at rows >= row_end and at
// columns >= ncols; one committed group; by THREADS threads, this one
// `tid`.  Into a raw 64 x W staging tile, or with IN_PLACE into the lo
// tile of a 64-row K-major operand at each value's own position
// (split_in_place then splits it there).
template <int W, bool IN_PLACE, int THREADS = kThreads>
__device__ __forceinline__ void stage_rows(void* dst_tile, const float* __restrict__ base,
                                           long long rs, int row0, int row_end,
                                           int ncols, int vec, int tid) {
  constexpr int kUnits = W / 4;               // 16-byte units of a row
  constexpr int kRows = THREADS / kUnits;     // rows a pass of the threads covers
  static_assert(THREADS % kUnits == 0 && kSlab % kRows == 0, "whole passes");
  const int u = tid % kUnits, r0 = tid / kUnits, col = 4 * u;
  const bool in_cols = col < ncols;
  const float* src = base + (row0 + r0) * rs + col;
  unsigned char* tile = static_cast<unsigned char*>(dst_tile);
#pragma unroll 4
  for (int r = r0; r < kSlab; r += kRows, src += kRows * rs) {
    float* dst = reinterpret_cast<float*>(
        tile + (IN_PLACE ? sw_off(kSlab, r, u) : 4 * (r * W + col)));
    if (row0 + r < row_end && in_cols) {
      if (vec) {
        cp_async16(smem_u32(dst), src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < ncols) cp_async4(smem_u32(dst + e), src + e);
          else dst[e] = 0.0f;
        }
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  cp_async_commit();
}

// a 64-row K-major operand (K = W) staged raw in its lo tile, split there
// into hi and lo
template <int W>
__device__ __forceinline__ void split_in_place(unsigned char* hi, unsigned char* lo) {
#pragma unroll 4
  for (int i = 0; i < kSlab * W / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const uint32_t off = sw_off(kSlab, idx / (W / 4), idx % (W / 4));
    store_split(hi, lo, off, *reinterpret_cast<const float4*>(lo + off));
  }
}

// the staged 64 x W tile transposed into hi and lo operands of W rows (its
// columns), K = its 64 steps, each step scaled by w[step] if SCALED, by
// THREADS threads, this one `tid`: unit q of a row holds steps 8 (q / 2) +
// (q & 1) + {0, 2, 4, 6}, so each group of 8 steps lies in the order
// 0 2 4 6 1 3 5 7 (see the design note).  Lanes take adjacent columns: the
// staging reads fall in 32 banks.
template <int W, bool SCALED, int THREADS = kThreads>
__device__ __forceinline__ void split_cols(unsigned char* hi, unsigned char* lo,
                                           const float* stage, const float* w, int tid) {
  static_assert(W * kSlab / 4 % THREADS == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < W * kSlab / 4 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int col = idx % W, q = idx / W;
    const int s = 8 * (q >> 1) + (q & 1);
    const float* src = stage + s * W + col;
    float4 v = make_float4(src[0], src[2 * W], src[4 * W], src[6 * W]);
    if (SCALED) {
      v.x *= w[s];
      v.y *= w[s + 2];
      v.z *= w[s + 4];
      v.w *= w[s + 6];
    }
    store_split(hi, lo, sw_off(W, col, q), v);
  }
}

// log_a (or dt) of the 64 steps [s0, s0 + 64) of a chunk for one warp: lane
// l takes steps s0 + l and s0 + 32 + l, 0 at or past `end`
__device__ __forceinline__ float2 load_slab(const float* __restrict__ v, long long stride,
                                            int s0, int end, int lane) {
  const int sa = s0 + lane, sb = sa + 32;
  return make_float2(sa < end ? v[sa * stride] : 0.0f, sb < end ? v[sb * stride] : 0.0f);
}

// The chain that gives every lcum of this file: a slab's lcum is its local
// inclusive scan (two warp scans of 32 steps) plus `carry`, the sum of the
// chunk's earlier slab totals in order, which it then advances by this
// slab's total.  v: the slab's log_a as load_slab gives it; returns lcum of
// the same steps.  One warp.
__device__ __forceinline__ float2 chain(float2 v, int lane, float& carry) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v.x, off);
    const float u1 = __shfl_up_sync(0xffffffffu, v.y, off);
    if (lane >= off) {
      v.x += u0;
      v.y += u1;
    }
  }
  v.y += __shfl_sync(0xffffffffu, v.x, 31);
  const float total = __shfl_sync(0xffffffffu, v.y, 31);
  const float2 lc = make_float2(v.x + carry, v.y + carry);
  carry += total;
  return lc;
}

__device__ __forceinline__ uint64_t desc(const unsigned char* tile, uint32_t off) {
  return sw128_desc(smem_u32(tile) + off, 16, 1024);
}

// byte offset of k8 step kk in a K-major operand of `rows` rows
__device__ __forceinline__ uint32_t k8_off(int rows, int kk) {
  return (kk / 4) * rows * 128 + (kk % 4) * 32;
}

// ---- 1. chunk states ----------------------------------------------------------------

template <int NP>
struct StateLayout {
  static constexpr int kX = kSlab * kSlab * 4;   // a head's X'^T hi or lo: 64 rows of P x 64 steps
  static constexpr int kB = NP * kSlab * 4;      // B^T hi or lo: NP rows x 64 steps
  // + 1,024 to align the tiles to the swizzle pattern's 1,024 bytes; the
  // raw staging tiles of each head's x (64 x 64) and of B (64 x NP); each
  // head's weights and l_end
  static constexpr int kSmem = 1024 + 4 * kX + 2 * kB + 2 * kX + kB + 4 * 2 * kSlab + 16;
};

// one block per (chunk c < nc - 1 and 64 rows of P, two heads, batch), one
// warpgroup a head: S_c's rows into states[b, h, c] (P x N) and l_end_c into
// l_end[b, h, c].  S_c = X'^T B with X'_s = w_s x_s, w_s = exp(l_end -
// lcum_s) dt_s, so that B^T, split once, serves both heads.  A second
// warpgroup without a head (odd H) only helps to copy and split B.
template <int NP>
__global__ void __launch_bounds__(2 * kThreads, 1)
ssd_tf32x3_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ la, const float* __restrict__ bm,
                        float* __restrict__ l_end, float* __restrict__ states, Dims d) {
  using L_ = StateLayout<NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* x_t = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // head k's X'^T hi, lo at 2 k kX
  unsigned char* b_hi = x_t + 4 * L_::kX;
  unsigned char* b_lo = b_hi + L_::kB;
  float* stage_x = reinterpret_cast<float*>(b_lo + L_::kB);   // head k's at k 64 x 64
  float* stage_b = stage_x + 2 * kSlab * kSlab;
  float* w = stage_b + kSlab * NP;   // head k's weights of the slab's steps at k 64
  float* l_end_s = w + 2 * kSlab;

  const int PH = (d.P + kSlab - 1) / kSlab;
  const int c = blockIdx.x / PH, p0 = (blockIdx.x % PH) * kSlab;
  const int b = blockIdx.z;
  const int c0 = c * d.Q, end = c0 + d.Q;   // a chunk before the last: whole
  const int tid = threadIdx.x, wg = tid / kThreads, t = tid % kThreads;
  const int wp = t >> 5, lane = tid & 31;
  const int h = blockIdx.y * 2 + wg;
  const bool live = h < d.H;   // this warpgroup has a head
  const int pcols = min(kSlab, d.P - p0);
  const float* xg = x + b * d.xb + min(h, d.H - 1) * d.xh + p0;
  const float* bg = bm + b * d.bb;
  const float* lg = la + b * d.lb + min(h, d.H - 1) * d.lh;
  const float* dg = dt + b * d.db + min(h, d.H - 1) * d.dh;
  unsigned char* xw_hi = x_t + 2 * wg * L_::kX;
  unsigned char* xw_lo = xw_hi + L_::kX;
  float* sx = stage_x + wg * kSlab * kSlab;
  float* ww = w + wg * kSlab;

  stage_rows<NP, false, 2 * kThreads>(stage_b, bg, d.bs, c0, end, d.N, d.vec, tid);
  if (live) stage_rows<kSlab, false>(sx, xg, d.xs, c0, end, pcols, d.vec, t);
  float2 la_n = make_float2(0.0f, 0.0f), dt_n = la_n;   // warp 0 of a head: the next slab's
  if (live && wp == 0) {   // l_end: the chain through the whole chunk
    float carry = 0.0f;
#pragma unroll 4
    for (int s0 = c0; s0 < end; s0 += kSlab)
      chain(load_slab(lg, d.ls, s0, end, lane), lane, carry);
    if (lane == 0) l_end_s[wg] = carry;
    la_n = load_slab(lg, d.ls, c0, end, lane);
    dt_n = load_slab(dg, d.ds, c0, end, lane);
  }
  __syncthreads();
  const float le = l_end_s[wg];

  float acc[NP / 2];
#pragma unroll
  for (int k = 0; k < NP / 2; ++k) acc[k] = 0.0f;
  float carry = 0.0f;   // warp 0's chain again, slab by slab
  for (int s0 = c0; s0 < end; s0 += kSlab) {
    if (live && wp == 0) {   // w = exp(l_end - lcum_s) dt_s (0 past the chunk: dt 0)
      const float2 lc = chain(la_n, lane, carry);
      ww[lane] = expf(le - lc.x) * dt_n.x;
      ww[lane + 32] = expf(le - lc.y) * dt_n.y;
      if (s0 + kSlab < end) {
        la_n = load_slab(lg, d.ls, s0 + kSlab, end, lane);
        dt_n = load_slab(dg, d.ds, s0 + kSlab, end, lane);
      }
    }
    cp_async_wait_all();
    __syncthreads();   // the slab is staged, the weights written; the last products are done
    split_cols<NP, false, 2 * kThreads>(b_hi, b_lo, stage_b, nullptr, tid);
    if (live) split_cols<kSlab, true>(xw_hi, xw_lo, sx, ww, t);
    fence_proxy_async();   // the split tiles are read by wgmma (async proxy)
    __syncthreads();       // the staging tiles are free
    if (s0 + kSlab < end) {
      stage_rows<NP, false, 2 * kThreads>(stage_b, bg, d.bs, s0 + kSlab, end, d.N, d.vec, tid);
      if (live) stage_rows<kSlab, false>(sx, xg, d.xs, s0 + kSlab, end, pcols, d.vec, t);
    }
    if (live) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 8; ++kk) {
        const uint32_t xo = k8_off(kSlab, kk), bo = k8_off(NP, kk);
        const uint64_t xh = desc(xw_hi, xo), bh = desc(b_hi, bo);
        wgmma_tf32_ss<NP>(acc, xh, desc(b_lo, bo), 1);
        wgmma_tf32_ss<NP>(acc, desc(xw_lo, xo), bh, 1);
        wgmma_tf32_ss<NP>(acc, xh, bh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
  }
  if (!live) return;

  // acc (64 rows of P x NP) -> states[b, h, c] (P x N)
  const long long bh = static_cast<long long>(b) * d.H + h;
  float* out = states + (bh * (d.nc - 1) + c) * static_cast<long long>(d.P) * d.N;
  const int pa = p0 + 16 * wp + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int k = 0; k < NP / 2; ++k) {
    const int p = pa + 8 * ((k >> 1) & 1);
    const int n = 8 * (k >> 2) + col + (k & 1);
    if (p < d.P && n < d.N) out[p * d.N + n] = acc[k];
  }
  if (p0 == 0 && t == 0) l_end[bh * (d.nc - 1) + c] = le;
}

// ---- 2. the pass over the chunks ----------------------------------------------------

// The state entering chunk c + 1, in_1 = S_0, in_{c+1} = exp(l_end_c) in_c +
// S_c, written as tiles[b, h, c, ph] = hi then lo, each 64 rows (p) x NP (n)
// tf32 K-major in 128-byte swizzled boxes of 32 (the outputs' B operand of
// C in^T), zero past P and N, so that an output block copies them as they
// are.  One thread per (b, h, p, n) of the padded tiles, walking the chunks
// in order.
template <int NP>
__global__ void __launch_bounds__(kPassThreads)
ssd_tf32x3_pass_kernel(const float* __restrict__ l_end, const float* __restrict__ states,
                       float* __restrict__ tiles, Dims d) {
  const int PH = (d.P + kSlab - 1) / kSlab;
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PH * kSlab * NP) return;
  const int p = e / NP, n = e % NP;
  const bool live = p < d.P && n < d.N;
  const long long PN = static_cast<long long>(d.P) * d.N;
  const long long bh = static_cast<long long>(b) * d.H + h;
  const float* le = l_end + bh * (d.nc - 1);
  const float* st = states + bh * (d.nc - 1) * PN + (live ? p * d.N + n : 0);
  constexpr long long kTile = 2LL * kSlab * NP;   // floats of one (hi, lo) pair
  float* out = tiles + (bh * (d.nc - 1) * PH + p / kSlab) * kTile +
               (sw_off(kSlab, p % kSlab, n >> 2) >> 2) + (n & 3);
  float run = 0.0f;
  for (int c = 0; c < d.nc - 1; ++c) {
    run = expf(le[c]) * run + (live ? st[c * PN] : 0.0f);
    uint32_t hi, lo;
    split32(run, hi, lo);
    float* t = out + c * PH * kTile;
    t[0] = __uint_as_float(hi);
    t[kSlab * NP] = __uint_as_float(lo);
  }
}

// ---- 3. the chunk products: G = C B^T, and C in^T ----------------------------------

constexpr int kGroup = 8;        // heads a chunk block takes C in^T for
constexpr int kFrag = 32 * kThreads;   // floats of a 64 x 64 accumulator tile

// G tiles: for each (batch, chunk), T = ts (ts + 1) / 2 tiles, (i, j) at
// i (i + 1) / 2 + j for j <= i, each kFrag floats in the accumulators'
// order (thread t's 32 values at 32 t), so that a thread of the outputs'
// warpgroup reads its own fragment with 16-byte loads
__device__ __forceinline__ long long gram_tile(const Dims& d, int b, int c, int i, int j) {
  const int ts = (d.Q + kSlab - 1) / kSlab;
  return ((static_cast<long long>(b) * d.nc + c) * (ts * (ts + 1) / 2) + i * (i + 1) / 2 + j) *
         kFrag;
}

template <int NP>
struct ChunkLayout {
  static constexpr int kC = kSlab * NP * 4;   // C's, B's or an entering state's hi or lo
  // + 1,024 to align the tiles to the swizzle pattern's 1,024 bytes; C hi
  // and lo; two buffers of hi and lo (B's slabs, the entering states); lcum
  // of the slab's rows for each head of the group
  static constexpr int kSmem = 1024 + 6 * kC + 4 * kGroup * kSlab;
};

// one block per (64-row slab i of chunk c, group of kGroup heads, batch):
// C's slab is split once; the group-0 block takes G_ij = C_i B_j^T for
// j <= i into `gram`; past the first chunk each block takes, for each head
// of its group and each 64 columns of P, y = exp(lcum_t) C in^T into y,
// which the outputs then add to.  Each product reads its second operand
// from a buffer that was filled while the last product ran (B's slab raw
// and split in place, or an entering state's tiles as the pass wrote them).
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tf32x3_chunk_kernel(const float* __restrict__ la, const float* __restrict__ bm,
                        const float* __restrict__ cm, const float* __restrict__ tiles,
                        float* __restrict__ gram, float* __restrict__ y, Dims d) {
  using L_ = ChunkLayout<NP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* c_hi = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* c_lo = c_hi + L_::kC;   // C's slab is staged here, raw, and split in place
  unsigned char* buf = c_lo + L_::kC;    // buffer k's hi at 2 k kC, lo at (2 k + 1) kC
  float* lc_rows = reinterpret_cast<float*>(buf + 4 * L_::kC);

  const int PH = (d.P + kSlab - 1) / kSlab;
  const int ts = (d.Q + kSlab - 1) / kSlab;
  const int i = ts - 1 - static_cast<int>(blockIdx.x) / d.nc;   // heaviest slabs first
  const int c = static_cast<int>(blockIdx.x) % d.nc;
  const int g = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.Q, end = min(c0 + d.Q, d.S);
  const int t0 = c0 + i * kSlab;
  const int h_first = g * kGroup, nh = min(kGroup, d.H - h_first);
  // the products: G_ij for j <= i (group 0), then C in^T for each (head, P half)
  const int n_gram = g == 0 ? i + 1 : 0;
  const int n_items = n_gram + (c > 0 ? nh * PH : 0);
  if (t0 >= end || n_items == 0) return;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int ksteps = (d.N + 7) / 8;
  const long long bh0 = static_cast<long long>(b) * d.H + h_first;

  // item n's second operand into buffer n & 1, one committed group
  auto fetch = [&](int n) {
    unsigned char* hi = buf + (n & 1) * 2 * L_::kC;
    if (n < n_gram) {
      stage_rows<NP, true>(hi + L_::kC, bm + b * d.bb, d.bs, c0 + n * kSlab, end, d.N,
                           d.vec, tid);
    } else {
      const int k = n - n_gram;
      const float* src = tiles + (((bh0 + k / PH) * (d.nc - 1) + c - 1) * PH + k % PH) *
                                     (2LL * kSlab * NP);
      for (int q = tid; q < 2 * kSlab * NP / 4; q += kThreads)
        cp_async16(smem_u32(hi) + 16 * q, src + 4 * q);
      cp_async_commit();
    }
  };
  stage_rows<NP, true>(c_lo, cm + b * d.cb, d.cs, t0, end, d.N, d.vec, tid);
  fetch(0);
  if (c > 0) {   // lcum of the slab's rows for each head of the group, warp w heads w, w + 4
    for (int k = wp; k < nh; k += 4) {
      const float* lg = la + b * d.lb + (h_first + k) * d.lh;
      float carry = 0.0f;
      float2 lc = make_float2(0.0f, 0.0f);
#pragma unroll 4
      for (int s = 0; s <= i; ++s)
        lc = chain(load_slab(lg, d.ls, c0 + s * kSlab, end, lane), lane, carry);
      lc_rows[k * kSlab + lane] = lc.x;
      lc_rows[k * kSlab + lane + 32] = lc.y;
    }
  }
  cp_async_wait_all_but_one();   // C's slab (item 0 may still be in flight)
  __syncthreads();
  split_in_place<NP>(c_hi, c_lo);
  fence_proxy_async();   // the split tiles are read by wgmma (async proxy)
  __syncthreads();

  const int ra = 16 * wp + (lane >> 2), rb = ra + 8;   // this thread's rows of the slab
  const int col = 2 * (lane & 3);
  for (int n = 0; n < n_items; ++n) {
    unsigned char* s_hi = buf + (n & 1) * 2 * L_::kC;
    unsigned char* s_lo = s_hi + L_::kC;
    if (n + 1 < n_items) {
      fetch(n + 1);   // the buffer's last product (item n - 1) is done
      cp_async_wait_all_but_one();
    } else {
      cp_async_wait_all();
    }
    fence_proxy_async();   // an entering state's tiles, copied by cp.async, are read by wgmma
    __syncthreads();       // item n's operand has landed
    if (n < n_gram) {
      split_in_place<NP>(s_hi, s_lo);
      fence_proxy_async();
      __syncthreads();
    }
    float acc[kSlab / 2];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 8; ++kk) {
      if (kk < ksteps) {
        const uint32_t off = k8_off(kSlab, kk);
        const uint64_t ch = desc(c_hi, off), sh = desc(s_hi, off);
        wgmma_tf32_ss<kSlab>(acc, ch, desc(s_lo, off), kk > 0);
        wgmma_tf32_ss<kSlab>(acc, desc(c_lo, off), sh, 1);
        wgmma_tf32_ss<kSlab>(acc, ch, sh, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (n < n_gram) {   // G_in into its tile, in the accumulators' order
      float4* dst = reinterpret_cast<float4*>(gram + gram_tile(d, b, c, i, n) + 32 * tid);
#pragma unroll
      for (int q = 0; q < kSlab / 8; ++q)
        dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {            // y = exp(lcum_t) C in^T for the slab's rows of the chunk
      const int k = n - n_gram, hk = k / PH, p0 = (k % PH) * kSlab;
      const int pcols = min(kSlab, d.P - p0);
      const float ea = expf(lc_rows[hk * kSlab + ra]), eb = expf(lc_rows[hk * kSlab + rb]);
      const long long ys = static_cast<long long>(d.H) * d.P;
      const long long hp = (h_first + hk) * static_cast<long long>(d.P) + p0;
#pragma unroll
      for (int q = 0; q < kSlab / 2; ++q) {
        const int t = (q & 2) ? t0 + rb : t0 + ra;
        const int p = 8 * (q >> 2) + col + (q & 1);
        if (t < end && p < pcols)
          y[(static_cast<long long>(b) * d.S + t) * ys + hp + p] = acc[q] * ((q & 2) ? eb : ea);
      }
    }
    __syncthreads();   // every warp is done with buffer n & 1
  }
}

// ---- 4. outputs ---------------------------------------------------------------------

struct OutLayout {
  static constexpr int kX = kSlab * kSlab * 4;   // X^T hi or lo; the raw x tile
  // + 1,024 to align the tiles to the swizzle pattern's 1,024 bytes; X^T hi
  // and lo, the raw x tile, a slab's (lcum, dt), lcum of the block's rows
  static constexpr int kSmem = 1024 + 3 * kX + 8 * kSlab + 4 * kSlab;
};

// one block (one warpgroup, three a SM) per (64-row slab i of chunk c and
// 64 columns of P, head, batch): y[b, t, h, p] for the slab's rows t and
// those columns: the chunk kernel's C in^T (past the first chunk),
// accumulated onto by sum_{s <= t} W'[t, s] x_s, W' formed from the G tiles
__global__ void __launch_bounds__(kThreads, 3)
ssd_tf32x3_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ la, const float* __restrict__ gram,
                      float* __restrict__ y, Dims d) {
  using L_ = OutLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* x_hi = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_lo = x_hi + L_::kX;
  float* stage_x = reinterpret_cast<float*>(x_lo + L_::kX);
  float2* cols = reinterpret_cast<float2*>(stage_x + kSlab * kSlab);   // (lcum, dt) of the slab's steps
  float* lc_row = reinterpret_cast<float*>(cols + kSlab);

  const int PH = (d.P + kSlab - 1) / kSlab;
  const int ts = (d.Q + kSlab - 1) / kSlab;
  const int per = d.nc * PH;
  const int i = ts - 1 - static_cast<int>(blockIdx.x) / per;   // heaviest slabs first
  const int c = static_cast<int>(blockIdx.x) % per / PH;
  const int ph = static_cast<int>(blockIdx.x) % PH, p0 = ph * kSlab;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.Q, end = min(c0 + d.Q, d.S);   // rows past end: the next chunk or past S
  const int t0 = c0 + i * kSlab;
  if (t0 >= end) return;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int pcols = min(kSlab, d.P - p0);
  const float* xg = x + b * d.xb + h * d.xh + p0;
  const float* lg = la + b * d.lb + h * d.lh;
  const float* dg = dt + b * d.db + h * d.dh;

  stage_rows<kSlab, false>(stage_x, xg, d.xs, c0, end, pcols, d.vec, tid);
  // warp 0: lcum of the slab's rows (the chain through slabs 0 .. i), then
  // log_a and dt of slab 0, each next slab's a slab ahead
  float carry = 0.0f;
  float2 la_n = make_float2(0.0f, 0.0f), dt_n = la_n;
  if (wp == 0) {
    float2 lc = la_n;
#pragma unroll 4
    for (int k = 0; k <= i; ++k)
      lc = chain(load_slab(lg, d.ls, c0 + k * kSlab, end, lane), lane, carry);
    lc_row[lane] = lc.x;
    lc_row[lane + 32] = lc.y;
    carry = 0.0f;
    la_n = load_slab(lg, d.ls, c0, end, lane);
    dt_n = load_slab(dg, d.ds, c0, end, lane);
  }
  // this thread's fragment of the G tiles G_i0 .. G_ii
  const float4* gt = reinterpret_cast<const float4*>(gram + gram_tile(d, b, c, i, 0) + 32 * tid);
  // y starts, past the first chunk, as the chunk kernel's C in^T at this
  // thread's places (loaded now, while the prologue's copies are in flight)
  const int ra = 16 * wp + (lane >> 2), rb = ra + 8;   // this thread's rows of the slab
  const int ta = t0 + ra, tb_ = t0 + rb;
  const int col = 2 * (lane & 3);                     // + 8 j + (k & 1)
  const long long ys = static_cast<long long>(d.H) * d.P;
  float* rows[2] = {y + (static_cast<long long>(b) * d.S + ta) * ys + h * d.P + p0,
                    y + (static_cast<long long>(b) * d.S + tb_) * ys + h * d.P + p0};
  float acc[kSlab / 2];
#pragma unroll
  for (int k = 0; k < kSlab / 2; ++k) {
    const int t = (k & 2) ? tb_ : ta;
    const int p = 8 * (k >> 2) + col + (k & 1);
    acc[k] = c > 0 && t < end && p < pcols ? rows[(k >> 1) & 1][p] : 0.0f;
  }

  for (int j = 0; j <= i; ++j) {
    const int s0 = c0 + j * kSlab;
    cp_async_wait_all();
    __syncthreads();   // slab j's x staged; the last product is done
    if (wp == 0) {     // slab j's lcum and dt; the next slab's loads
      const float2 lc = chain(la_n, lane, carry);
      cols[lane] = make_float2(lc.x, dt_n.x);
      cols[lane + 32] = make_float2(lc.y, dt_n.y);
      if (j < i) {
        la_n = load_slab(lg, d.ls, s0 + kSlab, end, lane);
        dt_n = load_slab(dg, d.ds, s0 + kSlab, end, lane);
      }
    }
    split_cols<kSlab, false>(x_hi, x_lo, stage_x, nullptr, tid);
    fence_proxy_async();   // the split tiles are read by wgmma (async proxy)
    __syncthreads();       // X^T and the columns are written; the raw x tile is free
    if (j < i) stage_rows<kSlab, false>(stage_x, xg, d.xs, s0 + kSlab, end, pcols, d.vec, tid);
    float g[kSlab / 2];
#pragma unroll
    for (int q = 0; q < kSlab / 8; ++q) {
      const float4 v = gt[j * (kFrag / 4) + q];
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
    }
    // W' = (G exp(lcum_t - lcum_s)) dt_s where s <= t, 0 elsewhere, the decay
    // as 2^((lcum_t - lcum_s) log2 e); hi + lo as the A fragments of the 8 k8
    // slices: rows (r, r + 8) at steps 2t, then at steps 2t + 1 (columns t
    // and t + 4 of the reordered slice)
    const float lta = lc_row[ra], ltb = lc_row[rb];
    uint32_t a_hi[kSlab / 8][4], a_lo[kSlab / 8][4];
#pragma unroll
    for (int kk = 0; kk < kSlab / 8; ++kk) {
      float wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kk + e;                      // g[k]
        const int q = 8 * (k >> 2) + col + (k & 1);    // its step in the slab
        const int row = (k & 2) ? tb_ : ta;
        const float lt = (k & 2) ? ltb : lta;
        const float2 cd = cols[q];
        wv[e] = (j < i || s0 + q <= row) ? g[k] * ex2((lt - cd.x) * kLog2e) * cd.y : 0.0f;
      }
      split32(wv[0], a_hi[kk][0], a_lo[kk][0]);
      split32(wv[2], a_hi[kk][1], a_lo[kk][1]);
      split32(wv[1], a_hi[kk][2], a_lo[kk][2]);
      split32(wv[3], a_hi[kk][3], a_lo[kk][3]);
    }
    // y += W'_hi X_lo + W'_lo X_hi + W'_hi X_hi over the slab's steps
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 8; ++kk) {
      const uint32_t off = k8_off(kSlab, kk);
      const uint64_t xh = desc(x_hi, off);
      wgmma_tf32_rs<kSlab>(acc, a_hi[kk], desc(x_lo, off), 1);
      wgmma_tf32_rs<kSlab>(acc, a_lo[kk], xh, 1);
      wgmma_tf32_rs<kSlab>(acc, a_hi[kk], xh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // y[b, t, h, p] for the slab's rows of the chunk
#pragma unroll
  for (int k = 0; k < kSlab / 2; k += 2) {
    const int half = (k >> 1) & 1;
    const int t = half ? tb_ : ta;
    const int p = 8 * (k >> 2) + col;
    if (t >= end || p >= pcols) continue;
    float* dst = rows[half] + p;
    if (p + 1 < pcols && (d.P & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[k], acc[k + 1]);
    } else {
      dst[0] = acc[k];
      if (p + 1 < pcols) dst[1] = acc[k + 1];
    }
  }
}

template <int NP>
int launch(const float* x, const float* dt, const float* la, const float* bm,
           const float* cm, float* y, float* l_end, float* states, float* tiles,
           float* gram, int B, const Dims& d, cudaStream_t stream) {
  const int PH = (d.P + kSlab - 1) / kSlab;
  const int ts = (d.Q + kSlab - 1) / kSlab;
  cudaError_t e;
  if (d.nc > 1) {
    auto k1 = ssd_tf32x3_state_kernel<NP>;
    constexpr int smem1 = StateLayout<NP>::kSmem;
    e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (e != cudaSuccess) return static_cast<int>(e);
    k1<<<dim3((d.nc - 1) * PH, (d.H + 1) / 2, B), 2 * kThreads, smem1, stream>>>(
        x, dt, la, bm, l_end, states, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (PH * kSlab * NP + kPassThreads - 1) / kPassThreads;
    ssd_tf32x3_pass_kernel<NP><<<dim3(blocks, d.H, B), kPassThreads, 0, stream>>>(
        l_end, states, tiles, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto k3 = ssd_tf32x3_chunk_kernel<NP>;
  constexpr int smem3 = ChunkLayout<NP>::kSmem;
  e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one group of heads when no state is carried: G alone
  const int groups = d.nc > 1 ? (d.H + kGroup - 1) / kGroup : 1;
  k3<<<dim3(ts * d.nc, groups, B), kThreads, smem3, stream>>>(la, bm, cm, tiles, gram, y, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int smem4 = OutLayout::kSmem;
  e = cudaFuncSetAttribute(ssd_tf32x3_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem4);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_tf32x3_out_kernel<<<dim3(ts * d.nc * PH, d.H, B), kThreads, smem4, stream>>>(
      x, dt, la, gram, y, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 x (B, S, H, P), B and C (B, S, N), dt and log_a (B, S, H); y (B,
// S, H, P) float32, contiguous.  Scratch, with nc = ceil(S / Q), ts =
// ceil(Q / 64), PH = ceil(P / 64) and NP = 64 or 128 (N rounded up), all
// float32: gram (B, nc, ts (ts + 1) / 2, 4,096) always; when nc > 1 also
// l_end (B, H, nc - 1), states (B, H, nc - 1, P, N) and tiles (B, H, nc - 1,
// PH, 2, 64, NP); gram and tiles 16-byte aligned.  P <= 128, N <= 128,
// S >= 1, Q >= 1, B and H <= 65,535 (the wrapper checks them).  Strides in
// elements: x (b, s, h), B (b, s), C (b, s), dt (b, s, h), log_a (b, s, h);
// any base.  Returns the cudaError_t of the launches.
extern "C" int ssd_launch(const float* x, const float* dt, const float* la,
                          const float* bm, const float* cm, float* y, float* l_end,
                          float* states, float* tiles, float* gram, int B, int S, int H,
                          int P, int N, int Q, long long xb, long long xs, long long xh,
                          long long bb, long long bs, long long cb, long long cs,
                          long long db, long long ds, long long dh, long long lb,
                          long long ls, long long lh, void* stream) {
  // 16-byte copies where every row segment of x, B and C starts 16-byte aligned
  const long long steps[7] = {xb, xs, xh, bb, bs, cb, cs};
  int vec = P % 4 == 0 && N % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
             reinterpret_cast<uintptr_t>(cm)) % 16 == 0;
  for (const long long s : steps) vec = vec && s % 4 == 0;
  const Dims d{S, H, P, N, Q, (S + Q - 1) / Q, vec, xb, xs, xh, bb, bs, cb, cs,
               db, ds, dh, lb, ls, lh};
  auto st = static_cast<cudaStream_t>(stream);
  if (N <= 64) return launch<64>(x, dt, la, bm, cm, y, l_end, states, tiles, gram, B, d, st);
  return launch<128>(x, dt, la, bm, cm, y, l_end, states, tiles, gram, B, d, st);
}
