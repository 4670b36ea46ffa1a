// The Hopper GEMM body of the fused MLP, K6f (mlp_fwd.cu) and K6b
// (mlp_bwd.cu), for bf16 operands: one kernel template, five epilogues.
//
//   D[m][n] = sum_k A[m][k] B[n][k]      f32 in the tensor cores' registers
//
// Each block owns a 128 x BN tile of D (BN 256 where the width allows it,
// else 128): two consumer warpgroups of 64 rows each and a producer, one
// thread of which keeps a ring of TMA loads in flight (2-D tensor maps,
// 64-element = 128-byte boxes along the 128 B swizzle, zeros past every
// edge; full / empty mbarriers). A consumer issues wgmma m64nBNk16 from
// shared memory, four k16 steps a stage, keeps one stage's products in
// flight and hands a stage back once the next one's products are issued.
// kOcc blocks share an SM: one (a 192 KB ring, a producer warpgroup,
// setmaxnreg 24 / 240 as attention_long_bwd.cuh) for the products whose
// epilogue is light, two (a 96 KB ring, a producer warp, at most 112
// registers, BN 128) for those whose gelu epilogue is not, so that one
// block's epilogue runs beside the other's products.
//
// Operands lie in one of two ways (kTrans):
//   K-major  (0): A (m, k) and B (n, k) contiguous along k, as the forward
//                 and the first two backward products read x, do, g, dh and
//                 the weights. A stage holds A as one box of 128 rows x 64
//                 and B as one box of BN rows x 64; a k16 step is 32 bytes
//                 along the swizzled rows.
//   MN-major (1): A stored (k, m) and B (k, n), contiguous along m and n,
//                 as the weight gradients read g, dh, do and x: their rows
//                 are the contraction. A stage holds 64 rows of k as boxes
//                 of 64 columns (one per consumer for A, BN / 64 for B,
//                 8 KB each, side by side: the descriptor's leading byte
//                 offset); a k16 step is 16 rows = 2048 bytes; the wgmma's
//                 transpose bits read the tiles as they lie.
//
// Epilogues (kEpi), on the accumulators of the finished tile:
//   kEpiBiasGelu  K6f's first product: hb = T(acc + b1) -> h (when stored),
//                 g = T(gelu(f32 hb)) -> the g workspace;
//   kEpiBias      K6f's second: out = T(acc + b2);
//   kEpiGeluGrad  K6b's first: from the stored h, dh = T(acc * gelu'(h))
//                 -> the dh workspace, g = T(gelu(h)) -> the g workspace;
//   kEpiPlain     K6b's second: dx = T(acc);
//   kEpiWgrad     K6b's weight gradients, two products in one launch
//                 (dW2 = g^T do and dW1^T = dh^T x, M = hidden, N = C, K =
//                 rows), the rows cut into a fixed list of chunks (the
//                 wrapper's plan: a multiple of 64 rows each, a function of
//                 the row count alone); each (product, chunk) block writes
//                 its f32 partial, and mlp_bwd.cu's sum pass adds the
//                 partials in chunk order: every weight gradient is the same
//                 sum from launch to launch, with no float atomics.
// The bf16 results leave through shared memory (the ring, free once both
// consumers are done with it: 64-row x 64-column boxes written in the TMA's
// 128 B swizzle, conflict-free) by TMA stores, which clip rows and columns
// past the edge; the f32 partials as 8-byte stores, four lanes covering one
// 32-byte sector.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

enum GemmEpi : int { kEpiBiasGelu = 0, kEpiBias = 1, kEpiGeluGrad = 2, kEpiPlain = 3,
                     kEpiWgrad = 4 };

constexpr int kGemmBM = 128;                 // rows of a block's tile: two consumers of 64
constexpr int kGemmBK = 64;                  // depth of a stage: one 128-byte swizzle row
constexpr int kGemmBox = 64 * 64 * 2;        // a 64 x 64 bf16 box, 8 KB
constexpr int kGemmProducerRegs = 24;
constexpr int kGemmConsumerRegs = 240;
// kOcc = 2 takes a producer warp and no setmaxnreg: ptxas compiles every
// instruction within the block's launch bound, and a wgmma of 64
// accumulators does not fit in the 80 registers of two 384-thread blocks
template <int kOcc>
constexpr int kGemmThreads = kOcc == 2 ? 288 : 384;
template <int kOcc>
constexpr int kGemmRingBytes = kOcc == 2 ? 96 * 1024 : 192 * 1024;
// the 1024 B in front align the ring for the swizzle; the barriers follow it
template <int kOcc>
constexpr int kGemmSmemBytes = 1024 + kGemmRingBytes<kOcc> + 256;

template <int BN>
constexpr int kGemmStageBytes = (kGemmBM + BN) * kGemmBK * 2;
template <int BN, int kOcc>
constexpr int kGemmStages = kGemmRingBytes<kOcc> / kGemmStageBytes<BN>;

struct GemmParams {
  CUtensorMap a[2];               // A of each product (the second only for kEpiWgrad)
  CUtensorMap b[2];
  CUtensorMap out[2];             // bf16 results: [0] h / out / dh / dx, [1] g
  const __nv_bfloat16* bias;      // kEpiBiasGelu: b1; kEpiBias: b2
  const __nv_bfloat16* h;         // kEpiGeluGrad: (m, n)
  float* part;                    // kEpiWgrad: (2, chunks, m, n)
  int m, n, k;                    // the product's rows, columns and depth
  int chunk_rows, chunks;         // kEpiWgrad: the rows (k) of each chunk, their number
  int store_out0;                 // kEpiBiasGelu: 0 when h is not stored
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

// A descriptor of a tile written by TMA with 128 B swizzle: 8-row groups of
// 128-byte rows 1024 B apart (the stride byte offset) and, for MN-major
// operands wider than 64, 64-column boxes ``lbo`` bytes apart (the leading
// byte offset; K-major tiles never read it).
__device__ __forceinline__ uint64_t gemm_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (+)= a b over one k16 step: wgmma m64nNk16, both operands in shared
// memory, K-major (kTrans 0) or MN-major (kTrans 1); ``acc`` 0 overwrites d.
// N = 128 is hopper.cuh's wgmma_ss_n128 on d's registers 0-31 and 32-63.
template <int kTrans>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n128<kTrans>(*reinterpret_cast<float(*)[32]>(d),
                        *reinterpret_cast<float(*)[32]>(d + 32), a, b, acc);
}

template <int kTrans>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc), "n"(kTrans));
}

template <int BN, int kTrans>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 256) {
    wgmma_n256<kTrans>(d, a, b, acc);
  } else {
    wgmma_n128<kTrans>(d, a, b, acc);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// The one-hot products of X2 (exp_voxelize2.cu): d += a b over one 32-byte k
// step, both operands K-major in shared memory (128 B swizzle), N = 96 or 128
// columns of b (wgmma's n). bf16: m64nNk16 into f32 (N = 128: wgmma_n128);
// s8: m64nNk32 into s32 (the integer form takes neither transpose nor negate
// operands: both operands K-major).
__device__ __forceinline__ void wgmma_onehot_bf16_n96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_onehot_s8_n96(int32_t (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_onehot_s8_n128(int32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_onehot(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 96) {
    wgmma_onehot_bf16_n96(d, a, b);
  } else {
    wgmma_n128<0>(d, a, b, 1);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_onehot(int32_t (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 96) {
    wgmma_onehot_s8_n96(d, a, b);
  } else {
    wgmma_onehot_s8_n128(d, a, b);
  }
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

constexpr float kGeluInvSqrt2 = 0.70710678118654752f;
constexpr float kGeluInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// gelu(h) and gelu'(h) from one evaluation of the Abramowitz & Stegun erf
// polynomial (mem_tpu/ops/mlp.py:38-51, :135-136): exp(-h^2 / 2), the
// density's factor, is the polynomial's exp(-a^2) at a = |h| / sqrt 2. The
// reciprocal and the exponential are the approximate hardware ones (a few
// f32 ulps; every result is rounded to bf16 next): the epilogue, not the
// products, is what these kernels spend their extra time on.
__device__ __forceinline__ void gelu_and_grad(float h, float& g, float& dg) {
  const float z = h * kGeluInvSqrt2;
  const float a = fabsf(z);
  const float t = rcp_approx(fmaf(0.3275911f, a, 1.0f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = ex2(-a * a * kLog2e);
  const float half_cdf = fmaf(0.5f, copysignf(1.0f - poly * e, z), 0.5f);
  g = h * half_cdf;
  dg = fmaf(h, e * kGeluInvSqrt2Pi, half_cdf);
}

__device__ __forceinline__ float gelu_only(float h) {
  float g, dg;
  gelu_and_grad(h, g, dg);
  return g;
}

template <int kEpi, int BN, int kOcc>
__device__ __forceinline__ void gemm_body(const GemmParams& p) {
  constexpr int kTrans = kEpi == kEpiWgrad ? 1 : 0;
  constexpr int kStages = kGemmStages<BN, kOcc>;
  constexpr int kStageBytes = kGemmStageBytes<BN>;
  constexpr int kABytes = kGemmBM * kGemmBK * 2;   // 16 KB: both consumers' A
  constexpr bool kTwoOut = kEpi == kEpiBiasGelu || kEpi == kEpiGeluGrad;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(2 * (kTwoOut ? 2 : 1) * (BN / 64) * kGemmBox <= kGemmRingBytes<kOcc>,
                "the epilogue's staging fits in the ring");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~uint32_t{1023};
  const uint32_t full0 = ring + kGemmRingBytes<kOcc>, empty0 = full0 + 8 * kStages;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kGemmBM;
  // kEpiWgrad: blockIdx.z = product * chunks + chunk; the chunk's rows of k
  const int prod = kEpi == kEpiWgrad ? static_cast<int>(blockIdx.z) / p.chunks : 0;
  const int chunk = kEpi == kEpiWgrad ? static_cast<int>(blockIdx.z) % p.chunks : 0;
  const int kbeg = chunk * p.chunk_rows;
  const int kend = kEpi == kEpiWgrad ? min(p.k, kbeg + p.chunk_rows) : p.k;
  const int nk = (kend - kbeg + kGemmBK - 1) / kGemmBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    if constexpr (kOcc == 1) regs_dec<kGemmProducerRegs>();
    if (threadIdx.x != 256) return;
    const CUtensorMap* ma = &p.a[prod];
    const CUtensorMap* mb = &p.b[prod];
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kStages;
      if (kb >= kStages) mbar_wait(empty0 + 8 * s, (kb / kStages - 1) & 1);
      const uint32_t st = ring + s * kStageBytes, bar = full0 + 8 * s;
      const int k0 = kbeg + kb * kGemmBK;
      mbar_expect_tx(bar, kStageBytes);
      if constexpr (kTrans) {
        tma_load_2d(st, ma, bar, m0, k0);
        tma_load_2d(st + kGemmBox, ma, bar, m0 + 64, k0);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i) {
          tma_load_2d(st + kABytes + i * kGemmBox, mb, bar, n0 + 64 * i, k0);
        }
      } else {
        tma_load_2d(st, ma, bar, k0, m0);
        tma_load_2d(st + kABytes, mb, bar, k0, n0);
      }
    }
    return;
  }
  if constexpr (kOcc == 1) regs_inc<kGemmConsumerRegs>();

  const int lane = threadIdx.x % 32, t = lane % 4, wtid = threadIdx.x % 128;
  const int trow = (wtid / 32) * 16 + lane / 4;   // row a of the warpgroup's 64; b = a + 8

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    mbar_wait(full0 + 8 * s, (kb / kStages) & 1);
    const uint32_t a = ring + s * kStageBytes + wg * kGemmBox;
    const uint32_t b = ring + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      if constexpr (kTrans) {
        wgmma_bn<BN, 1>(acc, gemm_desc(a + 2048 * kk, kGemmBox),
                        gemm_desc(b + 2048 * kk, kGemmBox), 1);
      } else {
        wgmma_bn<BN, 0>(acc, gemm_desc(a + 32 * kk, 16), gemm_desc(b + 32 * kk, 16), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();   // the stage before this one is read
    if (kb > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kb - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  if constexpr (kEpi == kEpiWgrad) {
    float* dst = p.part + (static_cast<int64_t>(prod * p.chunks + chunk) * p.m) * p.n;
    const int64_t ra = m0 + wg * 64 + trow, rb = ra + 8;   // m is a multiple of 128
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < p.n) {
        *reinterpret_cast<float2*>(dst + ra * p.n + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dst + rb * p.n + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    return;
  } else {
    named_barrier(1, 256);   // both consumers are done with the ring: it becomes the staging
    // this warpgroup's boxes: [output][64-column box], 64 rows of 128 B each
    const uint32_t region = ring + wg * (kTwoOut ? 2 : 1) * (BN / 64) * kGemmBox;
    const int ra = m0 + wg * 64 + trow, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
      uint32_t oa, ob, ga = 0, gb = 0;   // output 0 (and g) of rows a and b
      if constexpr (kEpi == kEpiBiasGelu || kEpi == kEpiBias) {
        const uint32_t bw = col < p.n ? ld_u32(p.bias + col) : 0u;
        oa = pack_bf16(v0 + bf16_lo(bw), v1 + bf16_hi(bw));
        ob = pack_bf16(v2 + bf16_lo(bw), v3 + bf16_hi(bw));
        if constexpr (kEpi == kEpiBiasGelu) {
          ga = pack_bf16(gelu_only(bf16_lo(oa)), gelu_only(bf16_hi(oa)));
          gb = pack_bf16(gelu_only(bf16_lo(ob)), gelu_only(bf16_hi(ob)));
        }
      } else if constexpr (kEpi == kEpiGeluGrad) {
        const bool cv = col < p.n;
        const __nv_bfloat16* hr = p.h + col;
        const uint32_t ha = cv && ra < p.m ? ld_u32(hr + static_cast<int64_t>(ra) * p.n) : 0u;
        const uint32_t hb = cv && rb < p.m ? ld_u32(hr + static_cast<int64_t>(rb) * p.n) : 0u;
        float g0, g1, g2, g3, d0, d1, d2, d3;
        gelu_and_grad(bf16_lo(ha), g0, d0);
        gelu_and_grad(bf16_hi(ha), g1, d1);
        gelu_and_grad(bf16_lo(hb), g2, d2);
        gelu_and_grad(bf16_hi(hb), g3, d3);
        oa = pack_bf16(v0 * d0, v1 * d1);
        ob = pack_bf16(v2 * d2, v3 * d3);
        ga = pack_bf16(g0, g1);
        gb = pack_bf16(g2, g3);
      } else {
        oa = pack_bf16(v0, v1);
        ob = pack_bf16(v2, v3);
      }
      // row r's 16-byte chunk c of a box lands at chunk c ^ (r % 8); rows a
      // and b share r % 8 = lane / 4
      const uint32_t at =
          region + (j / 8) * kGemmBox + trow * 128 + (((j % 8) ^ (lane / 4)) * 16) + 4 * t;
      st_shared_u32(at, oa);
      st_shared_u32(at + 8 * 128, ob);
      if constexpr (kTwoOut) {
        st_shared_u32(at + (BN / 64) * kGemmBox, ga);
        st_shared_u32(at + (BN / 64) * kGemmBox + 8 * 128, gb);
      }
    }
    fence_async_smem();
    named_barrier(2 + wg, 128);
    if (wtid == 0) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
        if (n0 + 64 * c >= p.n) break;
        if (kEpi != kEpiBiasGelu || p.store_out0) {
          tma_store_2d(&p.out[0], region + c * kGemmBox, n0 + 64 * c, m0 + wg * 64);
        }
        if constexpr (kTwoOut) {
          tma_store_2d(&p.out[1], region + (BN / 64 + c) * kGemmBox, n0 + 64 * c, m0 + wg * 64);
        }
      }
      bulk_commit();
      bulk_wait_read<0>();   // the block's shared memory outlives the stores' reads
    }
  }
}

// A 2-D map of a bf16 matrix of ``outer`` rows of ``inner`` elements, boxes
// of box_outer rows x 64 elements (128 bytes, 128 B swizzle), zeros past
// every edge. Needs a 16-byte aligned base and row stride.
cudaError_t gemm_map(EncodeTiled encode, CUtensorMap* map, const void* p, int inner, int outer,
                     int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tile width a product of n columns takes
constexpr int gemm_bn(int n) { return n % 256 == 0 ? 256 : 128; }

// One launch of ``kernel`` (a gemm_body instantiation at kOcc) over ``grid``.
template <int kOcc, typename Kernel>
int gemm_launch(Kernel kernel, bool& opted_in, const GemmParams& p, dim3 grid,
                cudaStream_t stream) {
  if (!opted_in) {   // the attribute is per kernel: set it once
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmemBytes<kOcc>);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  kernel<<<grid, kGemmThreads<kOcc>, kGemmSmemBytes<kOcc>, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
