// The row-tile kernels the fused MLP's forward (K6f, mlp_fwd.cu) and the
// first half of its backward (K6b, mlp_bwd.cu) share.
//
// Both are two chained products over one tile of rows with an elementwise
// step between them, the (rows, hidden) intermediate kept out of device
// memory except where the function itself stores it:
//
//   forward : s = x . W1        e: hb = T(s + b1), h <- hb (optional),
//                                  g = T(gelu(f32(hb)))     out = T(g . W2 + b2)
//   backward: s = do . W2^T     e: dh = T(s * gelu'(f32(h))), dh -> workspace
//                                                            dx = T(dh . W1^T)
//
// (T is the operand dtype, bf16 on the training path; sums are f32.) In
// both, the first product contracts over the C columns of the row tile and
// the second over the hidden columns, so one body serves both with the
// weights handed over as
//   w_in  (hidden, C): row j holds the C weights that make hidden column j
//                      (forward: W1^T, the fc1 weight as torch stores it;
//                      backward: W2 as the reference stores it);
//   w_out (C, hidden): row c holds the hidden weights that make output
//                      column c (forward: W2^T, torch's fc2 weight;
//                      backward: W1 as the reference stores it).
// Both are contiguous along the contraction, which is what the mma.sync
// "col" operand and 16-byte staging loads want.
//
// gelu is the exact form with the Abramowitz & Stegun 7.1.26 erf polynomial
// of mem_tpu/ops/mlp.py:38-51, taken from the rounded hb, and
// gelu'(h) = 0.5 (1 + erf(h / sqrt 2)) + h phi(h) (mlp.py:135-136).
//
// 1. mlp_rows_mma_kernel: bf16, C in {128, 384, 768}, hidden % 128 == 0.
//    One block of 8 warps owns 32 rows. The row tile (32 x C) stays in
//    shared memory; the hidden columns go by in steps of 32: the step's
//    w_in slab (32 x C) and w_out slab (C x 32) are staged, the 32 x 32
//    intermediate is one 16 x 8 mma tile per warp (k over C), the
//    elementwise step runs on the accumulator fragments and leaves its
//    bf16 result in shared memory, and the second product adds into the
//    block's 32 x C f32 output, C/8 columns per warp in registers
//    (96 registers at C = 768: 64 rows would need 192 and spill). Row
//    strides are padded by 8 elements so a warp's 32-bit fragment loads
//    hit 32 banks. A block reads both weights once per 32 rows, from L2:
//    that traffic, not device memory, bounds this version.
// 2. mlp_rows_kernel: every other shape and f32 (the tests' dtype): 8 rows
//    per block, f32 row tile and f32 output tile in shared memory, one
//    warp per output column with lanes over the contraction.
// Rows past the end are staged as zeros and never written.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// erf by Abramowitz & Stegun 7.1.26, as mem_tpu/ops/mlp.py:_erf_poly
__device__ __forceinline__ float erf_poly(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-a * a));
}

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float gelu_poly(float h) {
  return 0.5f * h * (1.0f + erf_poly(h * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad_poly(float h) {
  const float phi = expf(-0.5f * h * h) * kInvSqrt2Pi;
  return 0.5f * (1.0f + erf_poly(h * kInvSqrt2)) + h * phi;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// 1. tensor-core path
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 32;      // rows per block
constexpr int kMmaStep = 32;      // hidden columns per step
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kStepStride = kMmaStep + 8;   // 20 words: 8 rows x 4 lanes on 32 banks

bool rows_mma_width(int c) { return c == 128 || c == 384 || c == 768; }

// the tensor-core kernels take these widths (mlp_bwd.cu's column kernel
// tiles both widths by 128)
bool mlp_mma_shape(int c, int hidden) { return rows_mma_width(c) && hidden % 128 == 0; }

size_t rows_mma_smem(int c) {
  return (static_cast<size_t>(kMmaRows + kMmaStep) * (c + 8) +
          static_cast<size_t>(kMmaRows + c) * kStepStride) * 2;
}

// The elementwise step on one pair of neighbouring hidden columns of one
// row: returns the packed bf16 pair that feeds the second product.
template <bool kBwd>
__device__ __forceinline__ uint32_t mma_epilogue(float s0, float s1, bool valid, int64_t at,
                                                 float bias0, float bias1,
                                                 const __nv_bfloat16* h_in,
                                                 __nv_bfloat16* h_out) {
  if (kBwd) {
    const uint32_t hw = valid ? ld32(h_in + at) : 0u;
    const uint32_t dh = pack_bf16(s0 * gelu_grad_poly(bf16_lo(hw)),
                                  s1 * gelu_grad_poly(bf16_hi(hw)));
    if (valid) *reinterpret_cast<uint32_t*>(h_out + at) = dh;
    return dh;
  }
  const uint32_t hb = pack_bf16(s0 + bias0, s1 + bias1);
  if (valid && h_out != nullptr) *reinterpret_cast<uint32_t*>(h_out + at) = hb;
  return pack_bf16(gelu_poly(bf16_lo(hb)), gelu_poly(bf16_hi(hb)));
}

template <int C, bool kBwd>
__global__ void __launch_bounds__(kMmaThreads)
mlp_rows_mma_kernel(const __nv_bfloat16* __restrict__ a,      // (rows, C)
                    const __nv_bfloat16* __restrict__ w_in,   // (hidden, C)
                    const __nv_bfloat16* __restrict__ w_out,  // (C, hidden)
                    const __nv_bfloat16* __restrict__ b_in,   // (hidden), forward
                    const __nv_bfloat16* __restrict__ b_out,  // (C), forward
                    const __nv_bfloat16* __restrict__ h_in,   // (rows, hidden), backward
                    __nv_bfloat16* __restrict__ h_out,        // (rows, hidden) or null
                    __nv_bfloat16* __restrict__ out,          // (rows, C)
                    int rows, int hidden) {
  constexpr int kAs = C + 8;          // C/2 + 4 words, = 4 (mod 32): conflict-free
  constexpr int kNt = C / 64;         // 8-column output tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);   // [32][kAs] row tile
  __nv_bfloat16* w1s = as + kMmaRows * kAs;                      // [32][kAs] w_in slab
  __nv_bfloat16* gs = w1s + kMmaStep * kAs;                      // [32][40] step result
  __nv_bfloat16* w2s = gs + kMmaRows * kStepStride;              // [C][40] w_out slab

  const int r0 = blockIdx.x * kMmaRows;
  for (int idx = threadIdx.x; idx < kMmaRows * (C / 8); idx += kMmaThreads) {
    const int r = idx / (C / 8);
    const int seg = (idx % (C / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(a + static_cast<int64_t>(r0 + r) * C + seg);
    }
    *reinterpret_cast<uint4*>(as + r * kAs + seg) = val;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and column within an 8-wide tile)
  const int t = lane % 4;   // fragment column pair
  const int mt1 = warp / 4, nt1 = warp % 4;   // the warp's tile of the 32 x 32 step
  const int ra = mt1 * 16 + g, rb = ra + 8;
  const int hc = nt1 * 8 + t * 2;
  const bool va = r0 + ra < rows, vb = r0 + rb < rows;
  const int c0 = warp * (C / 8);              // the warp's output columns

  float acc[2][kNt][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  for (int h0 = 0; h0 < hidden; h0 += kMmaStep) {
    __syncthreads();   // the slabs and gs are free (and, first, the row tile is staged)
    for (int idx = threadIdx.x; idx < kMmaStep * (C / 8); idx += kMmaThreads) {
      const int j = idx / (C / 8);
      const int seg = (idx % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + j * kAs + seg) =
          *reinterpret_cast<const uint4*>(w_in + static_cast<int64_t>(h0 + j) * C + seg);
    }
    for (int idx = threadIdx.x; idx < C * (kMmaStep / 8); idx += kMmaThreads) {
      const int c = idx / (kMmaStep / 8);
      const int seg = (idx % (kMmaStep / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + c * kStepStride + seg) =
          *reinterpret_cast<const uint4*>(w_out + static_cast<int64_t>(c) * hidden + h0 + seg);
    }
    __syncthreads();

    // first product: the warp's 16 x 8 tile of the step, k over C
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const __nv_bfloat16* ar = as + ra * kAs + t * 2;
      const __nv_bfloat16* br = w1s + (nt1 * 8 + g) * kAs + t * 2;
#pragma unroll 8
      for (int k = 0; k < C; k += 16) {
        const uint32_t af[4] = {ld32(ar + k), ld32(ar + 8 * kAs + k), ld32(ar + k + 8),
                                ld32(ar + 8 * kAs + k + 8)};
        mma_bf16(s, af, ld32(br + k), ld32(br + k + 8));
      }
    }
    float bias0 = 0.f, bias1 = 0.f;
    if (!kBwd) {
      const uint32_t bw = ld32(b_in + h0 + hc);
      bias0 = bf16_lo(bw);
      bias1 = bf16_hi(bw);
    }
    const int64_t ata = static_cast<int64_t>(r0 + ra) * hidden + h0 + hc;
    const int64_t atb = static_cast<int64_t>(r0 + rb) * hidden + h0 + hc;
    *reinterpret_cast<uint32_t*>(gs + ra * kStepStride + hc) =
        mma_epilogue<kBwd>(s[0], s[1], va, ata, bias0, bias1, h_in, h_out);
    *reinterpret_cast<uint32_t*>(gs + rb * kStepStride + hc) =
        mma_epilogue<kBwd>(s[2], s[3], vb, atb, bias0, bias1, h_in, h_out);
    __syncthreads();

    // second product: 32 rows x the warp's C/8 columns, k over the step
#pragma unroll
    for (int ks = 0; ks < kMmaStep; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* gr = gs + (mt * 16 + g) * kStepStride + ks + t * 2;
        af[mt][0] = ld32(gr);
        af[mt][1] = ld32(gr + 8 * kStepStride);
        af[mt][2] = ld32(gr + 8);
        af[mt][3] = ld32(gr + 8 * kStepStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const __nv_bfloat16* wr = w2s + (c0 + nt * 8 + g) * kStepStride + ks + t * 2;
        const uint32_t b0 = ld32(wr), b1 = ld32(wr + 8);
        mma_bf16(acc[0][nt], af[0], b0, b1);
        mma_bf16(acc[1][nt], af[1], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row_a = r0 + mt * 16 + g, row_b = row_a + 8;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = c0 + nt * 8 + t * 2;
      float add0 = 0.f, add1 = 0.f;
      if (!kBwd) {
        const uint32_t bw = ld32(b_out + col);
        add0 = bf16_lo(bw);
        add1 = bf16_hi(bw);
      }
      if (row_a < rows) {
        *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row_a) * C + col) =
            pack_bf16(acc[mt][nt][0] + add0, acc[mt][nt][1] + add1);
      }
      if (row_b < rows) {
        *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row_b) * C + col) =
            pack_bf16(acc[mt][nt][2] + add0, acc[mt][nt][3] + add1);
      }
    }
  }
}

template <int C, bool kBwd>
int launch_rows_mma(const void* a, const void* w_in, const void* w_out, const void* b_in,
                    const void* b_out, const void* h_in, void* h_out, void* out, int rows,
                    int hidden, cudaStream_t stream) {
  const size_t smem = rows_mma_smem(C);
  static bool opted_in = false;   // the attribute is per kernel: set it once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_rows_mma_kernel<C, kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  using B = __nv_bfloat16;
  mlp_rows_mma_kernel<C, kBwd><<<(rows + kMmaRows - 1) / kMmaRows, kMmaThreads, smem, stream>>>(
      static_cast<const B*>(a), static_cast<const B*>(w_in), static_cast<const B*>(w_out),
      static_cast<const B*>(b_in), static_cast<const B*>(b_out), static_cast<const B*>(h_in),
      static_cast<B*>(h_out), static_cast<B*>(out), rows, hidden);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. scalar path: f32 or bf16, any widths
// ---------------------------------------------------------------------------

constexpr int kRows = 8;        // rows per block
constexpr int kStep = 256;      // hidden columns per step
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

size_t rows_smem(int c) {
  return (2 * static_cast<size_t>(kRows) * c + static_cast<size_t>(kRows) * kStep) *
         sizeof(float);
}

// the value of acc[lane] without indexing registers by a run-time value
__device__ __forceinline__ float pick(const float (&acc)[kRows], int lane) {
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) v = lane == r ? acc[r] : v;
  return v;
}

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
mlp_rows_kernel(const T* __restrict__ a, const T* __restrict__ w_in,
                const T* __restrict__ w_out, const T* __restrict__ b_in,
                const T* __restrict__ b_out, const T* __restrict__ h_in,
                T* __restrict__ h_out, T* __restrict__ out, int rows, int c, int hidden) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [kRows][c] row tile
  float* os = xs + kRows * c;                    // [kRows][c] output sums
  float* gs = os + kRows * c;                    // [kRows][kStep] step result

  const int r0 = blockIdx.x * kRows;
  for (int idx = threadIdx.x; idx < kRows * c; idx += kThreads) {
    const int r = idx / c;
    xs[idx] = r0 + r < rows ? to_f32(a[static_cast<int64_t>(r0) * c + idx]) : 0.f;
    os[idx] = 0.f;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t my_row = r0 + lane;   // lanes < kRows finish one row each

  for (int h0 = 0; h0 < hidden; h0 += kStep) {
    const int hn = min(kStep, hidden - h0);
    __syncthreads();   // gs is free (and, first, the row tile is staged)
    for (int j = warp; j < hn; j += kWarps) {
      const T* wr = w_in + static_cast<int64_t>(h0 + j) * c;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int e = lane; e < c; e += 32) {
        const float wv = to_f32(wr[e]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xs[r * c + e], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
      if (lane < kRows) {
        const float s = pick(acc, lane);
        const bool valid = my_row < rows;
        const int64_t at = my_row * hidden + h0 + j;
        float gv;
        if (kBwd) {
          const float hf = valid ? to_f32(h_in[at]) : 0.f;
          const T dh = from_f32<T>(s * gelu_grad_poly(hf));
          if (valid) h_out[at] = dh;
          gv = to_f32(dh);
        } else {
          const T hb = from_f32<T>(s + to_f32(b_in[h0 + j]));
          if (valid && h_out != nullptr) h_out[at] = hb;
          gv = to_f32(from_f32<T>(gelu_poly(to_f32(hb))));
        }
        gs[lane * kStep + j] = gv;
      }
    }
    __syncthreads();
    for (int col = warp; col < c; col += kWarps) {
      const T* wr = w_out + static_cast<int64_t>(col) * hidden + h0;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int e = lane; e < hn; e += 32) {
        const float wv = to_f32(wr[e]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(gs[r * kStep + e], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
      if (lane < kRows) os[lane * c + col] += pick(acc, lane);   // one lane owns the cell
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * c; idx += kThreads) {
    const int r = idx / c;
    if (r0 + r < rows) {
      const float add = kBwd ? 0.f : to_f32(b_out[idx - r * c]);
      out[static_cast<int64_t>(r0) * c + idx] = from_f32<T>(os[idx] + add);
    }
  }
}

template <typename T, bool kBwd>
int launch_rows(const void* a, const void* w_in, const void* w_out, const void* b_in,
                const void* b_out, const void* h_in, void* h_out, void* out, int rows, int c,
                int hidden, cudaStream_t stream) {
  const size_t smem = rows_smem(c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_rows_kernel<T, kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mlp_rows_kernel<T, kBwd><<<(rows + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w_in), static_cast<const T*>(w_out),
      static_cast<const T*>(b_in), static_cast<const T*>(b_out), static_cast<const T*>(h_in),
      static_cast<T*>(h_out), static_cast<T*>(out), rows, c, hidden);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* const* ptrs, int count) {
  uintptr_t all = 0;
  for (int i = 0; i < count; ++i) all |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return all % 16 == 0;
}

template <bool kBwd>
int dispatch_rows(bool mma, const void* a, const void* w_in, const void* w_out,
                  const void* b_in, const void* b_out, const void* h_in, void* h_out,
                  void* out, int rows, int c, int hidden, int is_bf16, cudaStream_t stream) {
  if (mma) {
    switch (c) {
      case 128: return launch_rows_mma<128, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out, out, rows, hidden, stream);
      case 384: return launch_rows_mma<384, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out, out, rows, hidden, stream);
      default: return launch_rows_mma<768, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out, out, rows, hidden, stream);
    }
  }
  return is_bf16 ? launch_rows<__nv_bfloat16, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out,
                                                    out, rows, c, hidden, stream)
                 : launch_rows<float, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out, out,
                                            rows, c, hidden, stream);
}

}  // namespace
