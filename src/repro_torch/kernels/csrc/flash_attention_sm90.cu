// Causal GQA flash attention, forward, bf16 inputs, for Hopper, sm_90a:
// tensor cores through wgmma, tiles copied by TMA.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (pallas_call at line 118; body _flash_kernel), for bf16 q, k, v.  Float32
// inputs take the CUDA-core kernel of flash_attention.cu; the wrapper
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
// - O += P V: P rounded to bf16 in registers is the A operand (the
//   accumulator layout of a k16 slice is the A layout), V (BC x DP, D
//   contiguous) is B read N-major from shared memory, O (64 x DP float32)
//   stays in registers.  The row sum is taken from the float32 P.
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

namespace {

constexpr int kRows = 128;           // query rows of a block
constexpr int kStages = 2;           // key/value ring depth
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr float kNegLarge = -1e30f;

// ---- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// box (c0 = column, c1 = row, c2 = head, c3 = batch) of a 4-d map into
// shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across the asm around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
// K-major (Q, K): the stride offset is 1,024 bytes (8 rows of 128 bytes),
// the leading offset unused.  N-major (V): leading offset = bytes between
// 64-column boxes, stride offset = 1,024 bytes (8 keys).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x (MUFU.EX2; flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- wgmma, one k16 step (bf16 in, float32 accumulators) ----------------------

// d (64 x 64) = (scale_d ? d : 0) + A (64 x 16) B^T, A and B (N x 16) in
// shared memory, both K-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) = (scale_d ? d : 0) + A (64 x 16) B^T, A and B (N x 16) in
// shared memory, both K-major (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) = (scale_d ? d : 0) + A (64 x 16) B, A in registers (the
// accumulator layout of a k16 slice), B (16 x 64) in shared memory N-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128) = (scale_d ? d : 0) + A (64 x 16) B, A in registers (the
// accumulator layout of a k16 slice), B (16 x 128) in shared memory N-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 256) = (scale_d ? d : 0) + A (64 x 16) B, A in registers (the
// accumulator layout of a k16 slice), B (16 x 256) in shared memory N-major
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

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
      const uint64_t dq = sw128_desc(q, 16, 1024), dk = sw128_desc(k, 16, 1024);
      if constexpr (BC == 128) {
        wgmma_ss_n128(s, dq, dk, kk > 0);
      } else {
        wgmma_ss_n64(s, dq, dk, kk > 0);
      }
    }
  }
}

// O += P V over the BC keys of a tile
template <int DP, int BC>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&p)[BC / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_tile + kk * 16 * 128, BC * 128, 1024);
    if constexpr (DP == 64) {
      wgmma_rs_n64(o, p[kk], dv, 1);
    } else if constexpr (DP == 128) {
      wgmma_rs_n128(o, p[kk], dv, 1);
    } else {
      wgmma_rs_n256(o, p[kk], dv, 1);
    }
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
      uint32_t p[BC / 16][4];
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
            p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      mbar_wait(full_v(st), ph);
      if (!skip) {
        fence_regs(o);
        wgmma_fence();
        pv_product<DP, BC>(o, p, sv + st * L::kTileBytes);
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


// ---- host side ------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at first use, so
// that the library links nothing beyond the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes beyond cudaError_t's range, for the wrapper's message.
constexpr int kErrNoEncode = 10001;   // no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10002;     // + CUresult: the map was refused
constexpr int kErrAlign = 10000;      // base or stride not 16-byte aligned

// A 4-d map over a (B, S, H, D) bf16 tensor with element strides (b, s, h),
// boxes of 64 columns x `rows` rows, 128-byte swizzle, zero fill out of bounds.
int make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
             long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return kErrAlign;
  for (const cuuint64_t s : strides)
    if (s % 16 != 0) return kErrAlign;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
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
