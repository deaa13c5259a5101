// Causal GQA flash attention, forward, bf16 inputs, for Hopper, sm_90a:
// tensor cores through wgmma, tiles copied by TMA.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (pallas_call at line 118; body _flash_kernel), for bf16 q, k, v.  Float32
// inputs take the tf32x3 kernel of flash_attention.cu; the wrapper
// (kernels/flash_attention.py) chooses by dtype.
//
//   out[b, q, h] = sum_k p[q, k] v[b, k, h // G] / max(sum_k p[q, k], 1e-30)
//   p[q, k]      = exp(s[q, k] - max_k s[q, k]) where the mask allows (q, k),
//                  0 elsewhere;  s = (q . k) / sqrt(D)
//
// with the causal mask (k <= q) and, with a window W > 0, k > q - W; G is
// Hq / Hkv.  Inputs in the (B, S, H, D) layout with any strides that are
// multiples of 16 bytes (unit stride along D) and 16-byte aligned bases;
// output bf16.  As in the TPU kernel: masked scores are -1e30 before the
// max, masked probabilities are zeroed after the exp, tiles that the causal
// mask or the window leaves empty are skipped, and the row sum is clamped
// at 1e-30.  Any S (ragged tiles masked), D <= 256.
//
// Bound on an H100: 4 D flops for every unmasked (query, key) pair, about
// 1.4e11 at qwen3-4b's layer (B 4, S 2,048, 32/8 heads, D 128) against 67
// MB moved: bound by operations, 0.14 ms at the bf16 tensor-core rate.
//
// Design (FlashAttention-3's shape, without its ping-pong):
// - one block of three warpgroups per (batch * query head, tile of 128
//   query rows), the heaviest causal tiles first.  Warpgroup 0 is the
//   producer: it gives up registers (setmaxnreg) and one of its threads
//   issues every TMA copy.  Warpgroups 1 and 2 are consumers, 64 query
//   rows each, with 240 registers a thread.
// - TMA (cp.async.bulk.tensor, 4-d maps over (D, S, H, B) built on the
//   host) copies the query tile once and streams key and value tiles of BC
//   rows through a ring of two stages, completion counted on mbarriers.
//   Every tile lands in 128-byte swizzled boxes of 64 columns, the layout
//   the wgmma descriptors name; boxes past S or past D are zero-filled,
//   which masks nothing by itself but keeps the padding finite and
//   contributes zero to every product.
// - S = Q K^T: wgmma m64nBCk16, both operands from shared memory, float32
//   accumulators in registers; only ceil(D / 16) k-steps are issued.
// - online softmax on the accumulator fragments: a row's values sit in the
//   4 lanes of a quad, reduced with two shuffles; the mask is applied only
//   on tiles that the diagonal, the window edge or S cuts.  Scores are kept
//   in base-2 units (times log2 e) so that each exp is one MUFU.EX2.
// - O += P_hi V + P_lo V: the float32 P of each k16 slice is split into
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), each the A operand of its own
//   wgmma from registers (the accumulator layout of a k16 slice is the A
//   layout), so P keeps about 16 significant bits, as the reference's
//   float32 P V needs; V (BC x DP, D contiguous) is B read N-major from
//   shared memory, O (64 x DP float32) stays in registers.  The row sum is
//   taken from the float32 P.
// - epilogue: O / max(l, 1e-30) rounded to bf16, written straight from
//   registers.
// - each consumer runs S, softmax and P V of a tile in turn, waiting for
//   each product; the two consumers overlap one's products with the
//   other's softmax only as the warp schedulers interleave them (no
//   ping-pong order).  Issuing S of tile j beside P V of tile j - 1 inside a
//   warpgroup (FlashAttention-3's intra-warpgroup overlap) was tried: ptxas
//   serialized the wgmmas (C7515) and it ran slower; so was a third stage,
//   which gained nothing.
// DP is D rounded up to 64, 128 or 256; BC is 128 keys, 64 at DP 256 so
// that O, S and P fit the consumers' registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;           // query rows of a block
constexpr int kStages = 2;           // key/value ring depth
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr float kNegLarge = -1e30f;

// ---- the kernel -------------------------------------------------------------------

// S = Q K^T into s, over the first `ksteps` 16-column slices of D
template <int DP, int BC>
__device__ __forceinline__ void qk_product(float (&s)[BC / 2], uint32_t q_tile,
                                           uint32_t k_tile, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk < ksteps) {
      const uint32_t q = q_tile + (kk / 4) * kRows * 128 + (kk % 4) * 32;
      const uint32_t k = k_tile + (kk / 4) * BC * 128 + (kk % 4) * 32;
      wgmma_ss<BC, 0, 0>(s, sw128_desc(q, 16, 1024), sw128_desc(k, 16, 1024), kk > 0);
    }
  }
}

// O += P_hi V + P_lo V over the BC keys of a tile
template <int DP, int BC>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&p_hi)[BC / 16][4],
                                           const uint32_t (&p_lo)[BC / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_tile + kk * 16 * 128, BC * 128, 1024);
    wgmma_rs<DP>(o, p_hi[kk], dv, 1);
    wgmma_rs<DP>(o, p_lo[kk], dv, 1);
  }
}

template <int DP, int BC>
struct Layout {
  static constexpr int kQBytes = kRows * DP * 2;   // DP / 64 boxes of 128 rows
  static constexpr int kTileBytes = BC * DP * 2;   // DP / 64 boxes of BC rows
  static constexpr int kBarriers = 1 + 3 * kStages;
  // + 1,024 to align the tiles to the swizzle pattern's 1,024 bytes
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
};

template <int DP, int BC>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ out, long long osb, long long oss,
                  long long osh, int S, int Hq, int Hkv, int D, int causal,
                  int window, float scale) {
  using L = Layout<DP, BC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + L::kQBytes;
  const uint32_t sv = sk + kStages * L::kTileBytes;
  const uint32_t bars = sv + kStages * L::kTileBytes;
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y / Hq, h = blockIdx.y - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + kRows, S) - 1;
  // key tiles that some row of the block needs
  const int kt_hi = causal ? q_last / BC : (S - 1) / BC;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BC : 0;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);   // lane 0 of each of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::kQBytes);
      for (int j = 0; j < DP / 64; ++j)
        tma_load(sq + j * kRows * 128, &tq, full_q, 64 * j, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(empty(st), ph ^ 1);   // the consumers are done with it
        const int k0 = (kt_lo + it) * BC;
        mbar_expect_tx(full_k(st), L::kTileBytes);
        for (int j = 0; j < DP / 64; ++j)
          tma_load(sk + st * L::kTileBytes + j * BC * 128, &tk, full_k(st), 64 * j,
                   k0, hk, b);
        mbar_expect_tx(full_v(st), L::kTileBytes);
        for (int j = 0; j < DP / 64; ++j)
          tma_load(sv + st * L::kTileBytes + j * BC * 128, &tv, full_v(st), 64 * j,
                   k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int r_lo = q0 + 64 * c;                 // the warpgroup's first row
    const int qa = r_lo + 16 * w + (lane >> 2);   // this thread's two rows
    const int qb = qa + 8;
    const int col = 2 * (lane & 3);               // + 8 j + (i & 1)
    const uint32_t q_tile = sq + c * 64 * 128;
    const int ksteps = (D + 15) / 16;
    // scores in base-2 units: exp(s scale - m) = 2^(s scale log2(e) - m')
    const float scale2 = scale * 1.4426950408889634f;

    float o[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] = 0.0f;
    float ma = kNegLarge, mb = kNegLarge, la = 0.0f, lb = 0.0f;

    mbar_wait(full_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (kt_lo + it) * BC;
      // every (row, key) pair of the tile masked for this warpgroup: skip
      const bool skip = r_lo >= S || (causal && k0 > r_lo + 63) ||
                        (window > 0 && k0 + BC - 1 <= r_lo - window);
      uint32_t p_hi[BC / 16][4], p_lo[BC / 16][4];
      mbar_wait(full_k(st), ph);
      if (!skip) {
        float s[BC / 2];
        fence_regs(s);
        wgmma_fence();
        qk_product<DP, BC>(s, q_tile, sk + st * L::kTileBytes, ksteps);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        const bool masked = k0 + BC > S || (causal && k0 + BC - 1 > r_lo) ||
                            (window > 0 && k0 <= r_lo + 63 - window);
        float mxa = kNegLarge, mxb = kNegLarge;
        uint64_t live = ~0ull;   // bit i: s[i] is an allowed (row, key) pair
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) {
          float x = s[i] * scale2;
          if (masked) {
            const int key = k0 + 8 * (i >> 2) + col + (i & 1);
            const int row = (i & 2) ? qb : qa;
            if (key >= S || (causal && key > row) ||
                (window > 0 && key <= row - window)) {
              live &= ~(1ull << i);
              x = kNegLarge;
            }
          }
          s[i] = x;
          if (i & 2) mxb = fmaxf(mxb, x); else mxa = fmaxf(mxa, x);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
          mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
        }
        const float na = fmaxf(ma, mxa), nb = fmaxf(mb, mxb);
        const float ca = ex2(ma - na), cb = ex2(mb - nb);
        ma = na;
        mb = nb;
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) {
          float e = ex2(s[i] - ((i & 2) ? nb : na));
          if (!((live >> i) & 1)) e = 0.0f;   // masked: zeroed after the exp
          s[i] = e;
          if (i & 2) sb += e; else sa += e;
        }
        la = la * ca + sa;
        lb = lb * cb + sb;
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) o[j] *= (j & 2) ? cb : ca;
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r],
                       p_lo[kk][r]);
      }
      mbar_wait(full_v(st), ph);
      if (!skip) {
        fence_regs(o);
        wgmma_fence();
        pv_product<DP, BC>(o, p_hi, p_lo, sv + st * L::kTileBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(empty(st));
    }

    // epilogue: the row sums across the quad, O / max(l, 1e-30) in bf16
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    const float ia = 1.0f / fmaxf(la, 1e-30f), ib = 1.0f / fmaxf(lb, 1e-30f);
    __nv_bfloat16* rows[2] = {out + b * osb + qa * oss + h * osh,
                              out + b * osb + qb * oss + h * osh};
#pragma unroll
    for (int j = 0; j < DP / 2; j += 2) {
      const int half = (j >> 1) & 1;
      const int row = half ? qb : qa;
      const int d = 8 * (j >> 2) + col;
      if (row >= S || d >= D) continue;
      const float inv = half ? ib : ia;
      __nv_bfloat16* dst = rows[half] + d;
      if (d + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
      } else {
        dst[0] = __float2bfloat16(o[j] * inv);
        if (d + 1 < D) dst[1] = __float2bfloat16(o[j + 1] * inv);
      }
    }
  }
}

template <int DP, int BC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int Hq, int Hkv, int D, const long long* st, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, Hq, D, st[0], st[1], st[2], kRows);
  if (err == 0) err = make_map(&tk, k, B, S, Hkv, D, st[3], st[4], st[5], BC);
  if (err == 0) err = make_map(&tv, v, B, S, Hkv, D, st[6], st[7], st[8], BC);
  if (err != 0) return err;
  constexpr int smem = Layout<DP, BC>::kSmem;
  auto kernel = flash_sm90_kernel<DP, BC>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kRows - 1) / kRows, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), st[9], st[10], st[11], S, Hq,
      Hkv, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B, S, Hq, D), k and v (B, S, Hkv, D); D <= 256, Hq a multiple of
// Hkv, S >= 1 (the wrapper checks them).  strides: (b, s, h) of q, k, v and
// out, in elements; bases and the strides of q, k, v 16-byte aligned.
// window <= 0: no window.  Returns 0, a cudaError_t, or 10000 (misaligned),
// 10001 (no cuTensorMapEncodeTiled), 10002 + CUresult (map refused).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S, int Hq,
    int Hkv, int D, long long qb, long long qs, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh,
    long long ob, long long os, long long oh, int causal, int window, float scale,
    void* stream) {
  const long long st[12] = {qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64, 128>(q, k, v, out, B, S, Hq, Hkv, D, st, causal, window,
                           scale, s);
  if (D <= 128)
    return launch<128, 128>(q, k, v, out, B, S, Hq, Hkv, D, st, causal, window,
                            scale, s);
  return launch<256, 64>(q, k, v, out, B, S, Hq, Hkv, D, st, causal, window, scale,
                         s);
}
