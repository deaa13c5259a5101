// Mamba2 SSD chunk scan for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/ssd.py, ssd_pallas (pallas_call at line 92;
// body _ssd_kernel).
//
// For each (batch b, head h), over chunks of Q steps with xdt = dt * x and
// lcum the inclusive cumsum of log_a within the chunk:
//
//   intra   y[t] += sum_{s <= t} (C_t . B_s) exp(lcum_t - lcum_s) xdt_s
//   inter   y[t] += exp(lcum_t) (C_t . state)
//   update  state = exp(l_end) state + sum_s exp(l_end - lcum_s) B_s (x) xdt_s
//
// state is (P x N), carried from chunk to chunk; y (B, S, H, P) float32,
// without the D * x skip term.  B and C are (B, S, N), shared by the heads.
// x, B and C float32 or bfloat16, dt and log_a float32, any strides with a
// unit stride along the last axis; S need not be a multiple of Q.
//
// Bound on an H100: at mamba2-1.3b's shape (S 2,048, H 64, P 64, N 128,
// Q 256) the chunk's products take about 80 flops per element of x moved,
// so the scan is bound by operations on the CUDA cores (67 TFLOP/s
// float32), not by its bytes.
//
// Design: one block of 256 threads (16 x 16) per (batch * head) walks the
// chunks in order and keeps the state in shared memory.  The Q x Q score
// tile of a 256-step chunk (256 KB in float32) does not fit a block's
// shared memory, so the chunk's rows are taken 64 at a time, and for each
// row tile the 64-step tiles of s <= t: C B^T in registers (thread (ty, tx)
// holds rows ty + 16 i, steps tx + 16 j), the decay applied where s <= t
// only (exp of a positive exponent above the diagonal is never taken), the
// weights through a 64 x 65 tile, then into the row tile's y, which starts
// as the inter-chunk term.  The state update then walks the chunk once
// more with B scaled by exp(l_end - lcum_s).  Rows of the shared tiles have
// odd strides, so the 16 rows a half warp reads fall in 16 banks.  One warp
// takes the cumsum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kWs = kTile + 1;
constexpr int kStateCols = 128;  // state columns a pass of the update holds

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* x;
  const float* dt;
  const float* la;
  const void* b;
  const void* c;
  float* y;
  int S, H, P, N, Q, ldn, ldp;
  long long xb, xs, xh;    // x strides (batch, step, head)
  long long db, ds, dh;    // dt strides
  long long lb, ls, lh;    // log_a strides
  long long bb, bs;        // B strides (batch, step)
  long long cb, cs;        // C strides
};

// rows [s0, s0 + 64) of B (or C) into dst (64 x ldn), each row scaled by
// scale[r] when given, 0 past the chunk's L steps
template <typename T>
__device__ __forceinline__ void load_bc(float* dst, const T* src, long long step,
                                        int s0, int L, int N, int ldn,
                                        const float* lc, float l_end) {
  for (int idx = threadIdx.x; idx < kTile * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    const int s = s0 + r;
    float v = 0.0f;
    if (s < L) {
      v = to_f(src[s * step + n]);
      if (lc != nullptr) v *= expf(l_end - lc[s]);
    }
    dst[r * ldn + n] = v;
  }
}

// xdt rows [s0, s0 + 64) of the chunk into dst (64 x ldp), 0 past L
template <typename T>
__device__ __forceinline__ void load_xdt(float* dst, const T* x, long long xs,
                                         const float* dt, long long ds, int s0,
                                         int L, int P, int ldp) {
  for (int idx = threadIdx.x; idx < kTile * P; idx += kThreads) {
    const int r = idx / P, p = idx - r * P;
    const int s = s0 + r;
    dst[r * ldp + p] = s < L ? to_f(x[s * xs + p]) * dt[s * ds] : 0.0f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  extern __shared__ float smem[];
  const int ldn = a.ldn, ldp = a.ldp, P = a.P, N = a.N;
  float* cs = smem;                    // 64 x ldn: C rows of the row tile
  float* bs = cs + kTile * ldn;        // 64 x ldn: B rows of a step tile
  float* xs = bs + kTile * ldn;        // 64 x ldp: xdt rows of a step tile
  float* ws = xs + kTile * ldp;        // 64 x kWs: decay-masked C B^T
  float* st = ws + kTile * kWs;        // (16 NJ) x ldn: the state, rows >= P zero
  float* lc = st + 16 * NJ * ldn;      // Q: lcum of the chunk

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bi = blockIdx.x / a.H, h = blockIdx.x - bi * a.H;
  const T* xg = static_cast<const T*>(a.x) + bi * a.xb + h * a.xh;
  const T* bg = static_cast<const T*>(a.b) + bi * a.bb;
  const T* cg = static_cast<const T*>(a.c) + bi * a.cb;
  const float* dg = a.dt + bi * a.db + h * a.dh;
  const float* lg = a.la + bi * a.lb + h * a.lh;

  for (int idx = threadIdx.x; idx < 16 * NJ * ldn; idx += kThreads) st[idx] = 0.0f;

  for (int c0 = 0; c0 < a.S; c0 += a.Q) {
    const int L = min(a.Q, a.S - c0);
    const T* xc = xg + c0 * a.xs;
    const T* bc = bg + c0 * a.bs;
    const T* cc = cg + c0 * a.cs;
    const float* dc = dg + c0 * a.ds;

    __syncthreads();  // the previous chunk's update is done with lc and st
    if (threadIdx.x < 32) {  // inclusive cumsum of log_a, 32 steps at a time
      const int lane = threadIdx.x;
      float carry = 0.0f;
      for (int base = 0; base < L; base += 32) {
        float v = base + lane < L ? lg[(c0 + base + lane) * a.ls] : 0.0f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (base + lane < L) lc[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float l_end = lc[L - 1];

    for (int t0 = 0; t0 < L; t0 += kTile) {
      load_bc(cs, cc + t0 * a.cs, a.cs, 0, L - t0, N, ldn, nullptr, 0.0f);
      __syncthreads();

      // inter-chunk: exp(lcum_t) (C_t . state)
      float y[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) y[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float sv = st[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i][j] += cv[i] * sv;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float e = t < L ? expf(lc[t]) : 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) y[i][j] *= e;
      }

      // intra-chunk, step tiles s0 <= the row tile's last row
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        __syncthreads();  // the previous step tile is read
        load_bc(bs, bc, a.bs, s0, L, N, ldn, nullptr, 0.0f);
        load_xdt(xs, xc, a.xs, dc, a.ds, s0, L, P, ldp);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            ws[(ty + 16 * i) * kWs + tx + 16 * j] =
                (s <= t && t < L) ? g[i][j] * expf(lc[t] - lc[s]) : 0.0f;
          }
        }
        __syncthreads();
        for (int s = 0; s < kTile; ++s) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = ws[(ty + 16 * i) * kWs + s];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float xv = xs[s * ldp + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i][j] += w[i] * xv;
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= L) continue;
        float* row = a.y + ((static_cast<long long>(bi) * a.S + c0 + t) * a.H + h) * P;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) row[p] = y[i][j];
        }
      }
      __syncthreads();  // cs and the step tiles are read
    }

    // state update: thread (ty, tx) owns rows ty + 16 i, columns
    // n0 + tx + 16 j of the state
    const float carry = expf(l_end);
    for (int n0 = 0; n0 < N; n0 += kStateCols) {
      float u[NJ][kStateCols / 16];
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int j = 0; j < kStateCols / 16; ++j) u[i][j] = 0.0f;
      for (int s0 = 0; s0 < L; s0 += kTile) {
        __syncthreads();
        load_bc(bs, bc, a.bs, s0, L, N, ldn, lc, l_end);
        load_xdt(xs, xc, a.xs, dc, a.ds, s0, L, P, ldp);
        __syncthreads();
        for (int s = 0; s < kTile; ++s) {
          float xv[NJ];
#pragma unroll
          for (int i = 0; i < NJ; ++i) {
            const int p = ty + 16 * i;
            xv[i] = p < P ? xs[s * ldp + p] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < kStateCols / 16; ++j) {
            const int n = n0 + tx + 16 * j;
            const float bv = n < N ? bs[s * ldn + n] : 0.0f;
#pragma unroll
            for (int i = 0; i < NJ; ++i) u[i][j] += xv[i] * bv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < kStateCols / 16; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n < N) st[p * ldn + n] = carry * st[p * ldn + n] + u[i][j];
        }
      }
    }
  }
}

template <typename T, int NJ>
int launch(Args a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t(2 * kTile) * a.ldn + size_t(kTile) * a.ldp + size_t(kTile) * kWs +
       size_t(16 * NJ) * a.ldn + a.Q);
  auto kernel = ssd_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * a.H, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(Args a, int B, cudaStream_t stream) {
  if (a.P <= 32) return launch<T, 2>(a, B, stream);
  if (a.P <= 64) return launch<T, 4>(a, B, stream);
  return launch<T, 8>(a, B, stream);
}

}  // namespace

// Shared memory the kernel asks for, in bytes (the wrapper refuses shapes
// above the card's 227 KB a block).
extern "C" long long ssd_smem_bytes(int P, int N, int Q) {
  const int nj = P <= 32 ? 2 : (P <= 64 ? 4 : 8);
  const long long ldn = N | 1, ldp = P | 1;
  return 4LL * (2 * kTile * ldn + kTile * ldp + kTile * kWs + 16LL * nj * ldn + Q);
}

// dtype 0: x, B and C float32, 1: bfloat16; dt, log_a float32; y (B, S, H,
// P) float32, contiguous.  P <= 128; Q >= 1.  Returns the cudaError_t of
// the launch.
extern "C" int ssd_launch(const void* x, const float* dt, const float* la,
                          const void* b, const void* c, float* y, int dtype, int B,
                          int S, int H, int P, int N, int Q, long long xb,
                          long long xs, long long xh, long long db, long long ds,
                          long long dh, long long lb, long long ls, long long lh,
                          long long bb, long long bs, long long cb, long long cs,
                          void* stream) {
  Args a{x, dt, la, b, c, y, S, H, P, N, Q, N | 1, P | 1,
         xb, xs, xh, db, ds, dh, lb, ls, lh, bb, bs, cb, cs};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, st);
  return dispatch<float>(a, B, st);
}
