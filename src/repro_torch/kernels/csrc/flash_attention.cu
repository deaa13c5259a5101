// Causal GQA flash attention, forward, float32 inputs, for Hopper, sm_90a:
// tensor cores through tf32 wgmma, each float32 product taken as three
// TF32 products (3xTF32), so the route keeps float32 accuracy.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (pallas_call at line 118; body _flash_kernel), for float32 q, k, v.  bf16
// inputs take flash_attention_sm90.cu; the wrapper
// (kernels/flash_attention.py) chooses by dtype.
//
//   out[b, q, h] = sum_k p[q, k] v[b, k, h // G] / max(sum_k p[q, k], 1e-30)
//   p[q, k]      = exp(s[q, k] - max_k s[q, k]) where the mask allows (q, k),
//                  0 elsewhere;  s = (q . k) / sqrt(D)
//
// with the causal mask (k <= q) and, with a window W > 0, k > q - W; G is
// Hq / Hkv.  Inputs in the (B, S, H, D) layout with any strides (unit
// stride along D) and any base, float32; output float32.  As in the TPU
// kernel: masked scores are -1e30 before the max, masked probabilities are
// zeroed after the exp, key tiles that the causal mask or the window leaves
// empty are skipped, and the row sum is clamped at 1e-30.  Any S (ragged
// tiles masked), D <= 256.
//
// Arithmetic: every float32 factor x enters a product as hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (cvt.rna: the tensor core
// would truncate), and a product a b as a_hi b_hi + a_hi b_lo + a_lo b_hi
// with float32 accumulation, for S = Q K^T and for O += P V (P the float32
// online-softmax probability).  hi + lo keeps about 21 significant bits of
// x, and the dropped a_lo b_lo is below 2^-21 of the product, so the route
// holds to the float32 oracle where one TF32 product (2^-11) would not.
// ref.attention_tf32x3_route_ref is this arithmetic tile for tile.
//
// Bound on an H100: 4 D flops for every unmasked (query, key) pair, about
// 6.9e10 at qwen3-4b's shape (B 2, S 2,048, 32/8 heads, D 128) against 168
// MB moved (0.05 ms); as three TF32 products each, 2.1e11 over the TF32
// tensor-core rate (495 TFLOP/s): 0.42 ms, bound by operations (1.03 ms on
// the CUDA cores' 67 TFLOP/s).
//
// Design:
// - one block per (batch * query head, tile of 64 WG query rows), the
//   heaviest causal tiles first; WG warpgroups, each a consumer of 64 rows
//   (wgmma's M).  No producer warpgroup: every float32 value has to pass
//   through a thread to be split anyway, so all threads copy and split.
// - shared memory holds Q_hi and Q_lo (split once), one buffer for the hi
//   and lo of the current key tile (then of the value tile), and a raw
//   staging tile that cp.async fills with the next tile while the tensor
//   cores work; 16-byte copies where the bases, strides and D allow, else
//   4-byte ones (views of a fused projection at any offset).  D is padded
//   with zeros to DP (exact), ragged rows past S are zeros.
// - every operand is K-major in 128-byte swizzled rows of 32 values (tf32
//   wgmma takes no transpose): Q and K as they come (D contiguous), V
//   transposed while it is split (keys contiguous).
// - S = Q K^T: wgmma m64nBCk8, both operands from shared memory, three per
//   k8 step of D (only ceil(D / 8) steps); the online softmax runs on the
//   accumulators in registers in base-2 units, as the bf16 route's does.
// - O += P V: P's hi and lo are A from registers.  A thread's accumulator
//   holds keys 2t and 2t + 1 of each k8 slice where tf32's A fragment wants
//   columns t and t + 4; so the value tile is stored with each group of 8
//   keys in the order 0 2 4 6 1 3 5 7, which makes the accumulator pairs
//   the A fragment with no shuffle (a sum over keys does not care about
//   their order).
// DP, BC, WG: D <= 64: 64, 64 keys, 2 warpgroups (113 KB of shared
// memory); D <= 128: 128, 64, 2 (225 KB); D <= 256: 256, 32, 1 (225 KB).

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kNegLarge = -1e30f;

struct Strides {
  long long b, s, h;
};

template <int DP, int BC, int WG>
struct Tiles {
  static constexpr int kRows = 64 * WG;        // query rows of a block
  static constexpr int kThreads = 128 * WG;    // a warpgroup per 64 rows
  // Q_hi or Q_lo: DP / 32 boxes of kRows rows x 128 bytes
  static constexpr int kQBytes = kRows * DP * 4;
  // K_hi or K_lo (DP / 32 boxes of BC rows), V^T_hi or V^T_lo (BC / 32
  // boxes of DP rows), or the raw staging tile (BC rows of DP floats)
  static constexpr int kTileBytes = BC * DP * 4;
  // + 1,024 to align the tiles to the swizzle pattern's 1,024 bytes
  static constexpr int kSmem = 1024 + 2 * kQBytes + 3 * kTileBytes;
};

// byte offset of the 16-byte unit u (values 4u .. 4u + 3 of K) of row r in
// a K-major operand of `rows` rows: boxes of 32 values, 128-byte swizzle
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int u) {
  return (u >> 3) * rows * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo,
                                            uint32_t off, float4 x) {
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// rows [row0, row0 + ROWS) of one head (base: its row 0, column 0) into
// Q_hi and Q_lo, through registers
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_q(unsigned char* hi, unsigned char* lo,
                                       const float* __restrict__ base, long long ss,
                                       int row0, int S, int D, int vec) {
  static_assert(ROWS * DP / 4 % THREADS == 0, "whole passes");
#pragma unroll 4
  for (int i = 0; i < ROWS * DP / 4 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / (DP / 4), u = idx % (DP / 4);
    const int row = row0 + r, d = 4 * u;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < S && d < D) {
      const float* src = base + row * ss + d;
      if (vec) {
        x = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        x.x = src[0];
        if (d + 1 < D) x.y = src[1];
        if (d + 2 < D) x.z = src[2];
        if (d + 3 < D) x.w = src[3];
      }
    }
    store_split(hi, lo, sw_off(ROWS, r, u), x);
  }
}

// rows [row0, row0 + BC) of one head into the staging tile by cp.async
// (zeros past S and past D), as one committed group
template <int DP, int BC, int THREADS>
__device__ __forceinline__ void stage_tile(float* stage, const float* __restrict__ base,
                                           long long ss, int row0, int S, int D,
                                           int vec) {
  static_assert(BC * DP / 4 % THREADS == 0, "whole passes");
#pragma unroll 4
  for (int i = 0; i < BC * DP / 4 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / (DP / 4), u = idx % (DP / 4);
    const int row = row0 + r, d = 4 * u;
    float* dst = stage + r * DP + d;
    if (row < S && d < D) {
      const float* src = base + row * ss + d;
      if (vec) {
        cp_async16(smem_u32(dst), src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (d + e < D) cp_async4(smem_u32(dst + e), src + e);
          else dst[e] = 0.0f;
        }
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  cp_async_commit();
}

// the staged key tile into K_hi and K_lo (rows = keys, K = D)
template <int DP, int BC, int THREADS>
__device__ __forceinline__ void split_k(unsigned char* hi, unsigned char* lo,
                                        const float* stage) {
#pragma unroll
  for (int i = 0; i < BC * DP / 4 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / (DP / 4), u = idx % (DP / 4);
    store_split(hi, lo, sw_off(BC, r, u),
                *reinterpret_cast<const float4*>(stage + r * DP + 4 * u));
  }
}

// the staged value tile into V^T_hi and V^T_lo (rows = D, K = keys): unit q
// of a row holds keys 8 (q / 2) + (q & 1) + {0, 2, 4, 6}, so each group of 8
// keys lies in the order 0 2 4 6 1 3 5 7 (see the design note).  Lanes take
// adjacent columns: the staging reads fall in 32 banks.
template <int DP, int BC, int THREADS>
__device__ __forceinline__ void split_v(unsigned char* hi, unsigned char* lo,
                                        const float* stage) {
  static_assert(THREADS % 32 == 0 && DP % 32 == 0, "a warp on 32 adjacent columns");
#pragma unroll
  for (int i = 0; i < DP * BC / 4 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int d = idx % DP, q = idx / DP;
    const float* src = stage + (8 * (q >> 1) + (q & 1)) * DP + d;
    store_split(hi, lo, sw_off(DP, d, q),
                make_float4(src[0], src[2 * DP], src[4 * DP], src[6 * DP]));
  }
}

// S = Q K^T over the first `ksteps` k8 steps of D: Q_hi K_lo + Q_lo K_hi +
// Q_hi K_hi a step; q_hi / q_lo: the warpgroup's 64 rows in boxes of ROWS
template <int DP, int BC, int ROWS>
__device__ __forceinline__ void qk_product(float (&s)[BC / 2], uint32_t q_hi,
                                           uint32_t q_lo, uint32_t k_hi,
                                           uint32_t k_lo, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    if (kk < ksteps) {
      const uint32_t qo = (kk / 4) * ROWS * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * BC * 128 + (kk % 4) * 32;
      const uint64_t qh = sw128_desc(q_hi + qo, 16, 1024);
      const uint64_t kh = sw128_desc(k_hi + ko, 16, 1024);
      wgmma_tf32_ss<BC>(s, qh, sw128_desc(k_lo + ko, 16, 1024), kk > 0);
      wgmma_tf32_ss<BC>(s, sw128_desc(q_lo + qo, 16, 1024), kh, 1);
      wgmma_tf32_ss<BC>(s, qh, kh, 1);
    }
  }
}

// O += P_hi V_lo + P_lo V_hi + P_hi V_hi over the BC keys of a tile
template <int DP, int BC>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&p_hi)[BC / 8][4],
                                           const uint32_t (&p_lo)[BC / 8][4],
                                           uint32_t v_hi, uint32_t v_lo) {
#pragma unroll
  for (int kk = 0; kk < BC / 8; ++kk) {
    const uint32_t off = (kk / 4) * DP * 128 + (kk % 4) * 32;
    const uint64_t vh = sw128_desc(v_hi + off, 16, 1024);
    wgmma_tf32_rs<DP>(o, p_hi[kk], sw128_desc(v_lo + off, 16, 1024), 1);
    wgmma_tf32_rs<DP>(o, p_lo[kk], vh, 1);
    wgmma_tf32_rs<DP>(o, p_hi[kk], vh, 1);
  }
}

template <int DP, int BC, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int S,
                    int Hq, int Hkv, int D, Strides qst, Strides kst, Strides vst,
                    Strides ost, int causal, int window, float scale, int vec) {
  using T = Tiles<DP, BC, WG>;
  constexpr int kRows = T::kRows, kThreads = T::kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_hi = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_lo = q_hi + T::kQBytes;
  unsigned char* t_hi = q_lo + T::kQBytes;   // the key tile, then the value tile
  unsigned char* t_lo = t_hi + T::kTileBytes;
  float* stage = reinterpret_cast<float*>(t_lo + T::kTileBytes);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y / Hq, h = blockIdx.y - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + kRows, S) - 1;
  // key tiles that some row of the block needs
  const int kt_hi = causal ? q_last / BC : (S - 1) / BC;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BC : 0;
  const int n_tiles = kt_hi - kt_lo + 1;
  const float* kbase = k + b * kst.b + hk * kst.h;
  const float* vbase = v + b * vst.b + hk * vst.h;

  stage_tile<DP, BC, kThreads>(stage, kbase, kst.s, kt_lo * BC, S, D, vec);
  load_q<DP, kRows, kThreads>(q_hi, q_lo, q + b * qst.b + h * qst.h, qst.s, q0, S, D,
                              vec);
  cp_async_wait_all();
  __syncthreads();
  split_k<DP, BC, kThreads>(t_hi, t_lo, stage);
  fence_proxy_async();   // the split tiles are read by wgmma (async proxy)
  __syncthreads();
  stage_tile<DP, BC, kThreads>(stage, vbase, vst.s, kt_lo * BC, S, D, vec);

  const int c = threadIdx.x / 128;
  const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
  const int r_lo = q0 + 64 * c;                 // the warpgroup's first row
  const int qa = r_lo + 16 * w + (lane >> 2);   // this thread's two rows
  const int qb = qa + 8;
  const int col = 2 * (lane & 3);               // + 8 j + (i & 1)
  const uint32_t wq_hi = smem_u32(q_hi) + c * 64 * 128;
  const uint32_t wq_lo = smem_u32(q_lo) + c * 64 * 128;
  const uint32_t tile_hi = smem_u32(t_hi), tile_lo = smem_u32(t_lo);
  const int ksteps = (D + 7) / 8;
  // scores in base-2 units: exp(s scale - m) = 2^(s scale log2(e) - m')
  const float scale2 = scale * 1.4426950408889634f;

  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.0f;
  float ma = kNegLarge, mb = kNegLarge, la = 0.0f, lb = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (kt_lo + it) * BC;
    // every (row, key) pair of the tile masked for this warpgroup: skip
    const bool skip = r_lo >= S || (causal && k0 > r_lo + 63) ||
                      (window > 0 && k0 + BC - 1 <= r_lo - window);
    uint32_t p_hi[BC / 8][4], p_lo[BC / 8][4];
    if (!skip) {
      float s[BC / 2];
      fence_regs(s);
      wgmma_fence();
      qk_product<DP, BC, kRows>(s, wq_hi, wq_lo, tile_hi, tile_lo, ksteps);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const bool masked = k0 + BC > S || (causal && k0 + BC - 1 > r_lo) ||
                          (window > 0 && k0 <= r_lo + 63 - window);
      float mxa = kNegLarge, mxb = kNegLarge;
      uint32_t live = ~0u;   // bit i: s[i] is an allowed (row, key) pair
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        float x = s[i] * scale2;
        if (masked) {
          const int key = k0 + 8 * (i >> 2) + col + (i & 1);
          const int row = (i & 2) ? qb : qa;
          if (key >= S || (causal && key > row) ||
              (window > 0 && key <= row - window)) {
            live &= ~(1u << i);
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
      // the A fragment of k8 slice kk: rows (r, r + 8) at keys 2t, then at
      // keys 2t + 1 (columns t and t + 4 of the reordered slice)
#pragma unroll
      for (int kk = 0; kk < BC / 8; ++kk) {
        split_tf32(s[4 * kk + 0], p_hi[kk][0], p_lo[kk][0]);
        split_tf32(s[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
        split_tf32(s[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
        split_tf32(s[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();   // every warpgroup is done with the key tile; V staged
    split_v<DP, BC, kThreads>(t_hi, t_lo, stage);
    fence_proxy_async();
    __syncthreads();   // V^T split; the staging tile is free
    if (it + 1 < n_tiles)
      stage_tile<DP, BC, kThreads>(stage, kbase, kst.s, k0 + BC, S, D, vec);
    if (!skip) {
      fence_regs(o);
      wgmma_fence();
      pv_product<DP, BC>(o, p_hi, p_lo, tile_hi, tile_lo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    if (it + 1 < n_tiles) {
      cp_async_wait_all();
      __syncthreads();   // every warpgroup is done with V^T; the next K staged
      split_k<DP, BC, kThreads>(t_hi, t_lo, stage);
      fence_proxy_async();
      __syncthreads();
      stage_tile<DP, BC, kThreads>(stage, vbase, vst.s, k0 + BC, S, D, vec);
    }
  }

  // epilogue: the row sums across the quad, O / max(l, 1e-30)
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  const float ia = 1.0f / fmaxf(la, 1e-30f), ib = 1.0f / fmaxf(lb, 1e-30f);
  float* rows[2] = {out + b * ost.b + qa * ost.s + h * ost.h,
                    out + b * ost.b + qb * ost.s + h * ost.h};
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int half = (j >> 1) & 1;
    const int row = half ? qb : qa;
    const int d = 8 * (j >> 2) + col;
    if (row >= S || d >= D) continue;
    const float inv = half ? ib : ia;
    float* dst = rows[half] + d;
    if (d + 1 < D && (D & 1) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(o[j] * inv, o[j + 1] * inv);
    } else {
      dst[0] = o[j] * inv;
      if (d + 1 < D) dst[1] = o[j + 1] * inv;
    }
  }
}

template <int DP, int BC, int WG>
int launch(const float* q, const float* k, const float* v, float* out, int B, int S,
           int Hq, int Hkv, int D, Strides qst, Strides kst, Strides vst,
           Strides ost, int causal, int window, float scale, int vec,
           cudaStream_t stream) {
  using T = Tiles<DP, BC, WG>;
  auto kernel = flash_tf32x3_kernel<DP, BC, WG>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + T::kRows - 1) / T::kRows, B * Hq);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(q, k, v, out, S, Hq, Hkv, D, qst,
                                                  kst, vst, ost, causal, window,
                                                  scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 q (B, S, Hq, D), k and v (B, S, Hkv, D).  D <= 256, Hq a multiple
// of Hkv, S >= 1; the wrapper checks them.  strides: (b, s, h) of q, k, v,
// out in elements.  window <= 0: no window.  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S, int Hq,
    int Hkv, int D, long long qb, long long qs, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh,
    long long ob, long long os, long long oh, int causal, int window, float scale,
    void* stream) {
  const Strides qst{qb, qs, qh}, kst{kb, ks, kh}, vst{vb, vs, vh}, ost{ob, os, oh};
  // 16-byte copies where every row segment of q, k and v starts 16-byte aligned
  const long long steps[9] = {qb, qs, qh, kb, ks, kh, vb, vs, vh};
  int vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (const long long s : steps) vec = vec && s % 4 == 0;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64, 64, 2>(qf, kf, vf, of, B, S, Hq, Hkv, D, qst, kst, vst, ost,
                             causal, window, scale, vec, st);
  if (D <= 128)
    return launch<128, 64, 2>(qf, kf, vf, of, B, S, Hq, Hkv, D, qst, kst, vst, ost,
                              causal, window, scale, vec, st);
  return launch<256, 32, 1>(qf, kf, vf, of, B, S, Hq, Hkv, D, qst, kst, vst, ost,
                            causal, window, scale, vec, st);
}
