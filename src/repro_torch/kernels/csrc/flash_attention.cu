// Causal GQA flash attention, forward, float32 inputs, for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (pallas_call at line 118; body _flash_kernel), for float32 q, k, v.  bf16
// inputs take the tensor-core kernel of flash_attention_sm90.cu; the
// wrapper (kernels/flash_attention.py) chooses by dtype.
//
//   out[b, q, h] = sum_k p[q, k] v[b, k, h // G] / max(sum_k p[q, k], 1e-30)
//   p[q, k]      = exp(s[q, k] - max_k s[q, k]) where the mask allows (q, k),
//                  0 elsewhere;  s = (q . k) / sqrt(D)
//
// with the causal mask (k <= q) and, with a window W > 0, k > q - W; G is
// Hq / Hkv.  Inputs in the (B, S, H, D) layout with any strides (unit
// stride along D), float32; everything is computed in float32.
//
// Bound on an H100: at the models' shapes (S 2,048, D 128) the work is
// 4 D flops for every unmasked (query, key) pair, about 1.4e11 flops per
// qwen3-4b layer at B 4 against 67 MB moved, so the kernel is bound by
// operations: about 2 ms at the float32 rate of the CUDA cores (67
// TFLOP/s).  This one is the simple kernel on the CUDA cores.
//
// Design: one block of 256 threads (16 x 16) per (batch * query head,
// tile of 64 query rows), the heaviest causal tiles launched first.  The
// query tile stays in shared memory; key tiles of 64 stream through one
// buffer that then takes the value tile, so two blocks fit an SM at D 128.
// Thread (ty, tx) holds the scores of rows ty + 16 i and keys tx + 16 j
// (i, j < 4) in registers, and the output rows ty + 16 i at columns
// tx + 16 j (j < NJ = ceil(D / 16)); a row's 16 threads are one half warp,
// so the running max and sum are reduced with shuffles.  Rows are stored
// with an odd stride, so the 16 rows a half warp reads fall in 16 banks.
// As in the TPU kernel: masked scores are -1e30 before the max, masked
// probabilities are zeroed after the exp (a row whose first live tile is
// fully masked would otherwise get weight exp(0)), key tiles that the
// causal mask or the window leaves empty are skipped, and the sum is
// clamped at 1e-30.  Any S: the ragged last tiles are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // query rows of a block
constexpr int kCols = 64;     // keys of a tile
constexpr int kThreads = 256;
constexpr int kPs = kCols + 1;  // row stride of the probability tile
constexpr float kNegLarge = -1e30f;

struct Strides {
  long long b, s, h;
};

// rows [row0, row0 + 64) of head `head` of t into a 64 x ld tile (0 past S)
__device__ __forceinline__ void load_tile(float* dst, const float* t, Strides st,
                                          int b, int head, int row0, int S,
                                          int D, int ld) {
  const float* base = t + b * st.b + head * st.h;
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + d] = row < S ? base[row * st.s + d] : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S, int Hq,
             int Hkv, int D, int ld, Strides qst, Strides kst, Strides vst,
             Strides ost, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // kRows x ld
  float* kv = qs + kRows * ld;    // kCols x ld: the key tile, then the value tile
  float* ps = kv + kCols * ld;    // kRows x kPs

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y / Hq, h = blockIdx.y - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q_last = min(q0 + kRows, S) - 1;

  load_tile(qs, q, qst, b, h, q0, S, D, ld);

  float o[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegLarge;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  }

  const int k_tiles = causal ? q_last / kCols + 1 : (S + kCols - 1) / kCols;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kCols;
    if (window > 0 && k0 + kCols - 1 <= q0 - window) continue;  // left of the window

    __syncthreads();  // the previous tile's values are read
    load_tile(kv, k, kst, b, hk, k0, S, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool live[4];
      float mx = kNegLarge;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < S && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegLarge;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= corr;
    }

    __syncthreads();  // the keys are read, the probabilities written
    load_tile(kv, v, vst, b, hk, k0, S, D, ld);
    __syncthreads();

    for (int c = 0; c < kCols; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPs + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = kv[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* row = out + b * ost.b + qpos * ost.s + h * ost.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = o[i][j] * inv;
    }
  }
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int Hq, int Hkv, int D, Strides qst, Strides kst, Strides vst,
           Strides ost, int causal, int window, float scale, cudaStream_t stream) {
  const int ld = D | 1;  // odd: a half warp's 16 rows fall in 16 banks
  const size_t smem = sizeof(float) * (size_t(kRows + kCols) * ld + size_t(kRows) * kPs);
  auto kernel = flash_kernel<NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Hq, Hkv, D, ld, qst,
      kst, vst, ost, causal, window, scale);
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
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<4>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, vst, ost, causal,
                     window, scale, st);
  if (D <= 128)
    return launch<8>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, vst, ost, causal,
                     window, scale, st);
  return launch<16>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, vst, ost, causal,
                    window, scale, st);
}
