// The scalar row-tile kernel of the fused MLP's forward (K6f, mlp_fwd.cu)
// and of the first half of its backward (K6b, mlp_bwd.cu): f32 operands
// (the tests' dtype; tensor cores would round them to TF32) and every bf16
// width outside the Hopper GEMM's (gemm_sm90.cuh). bf16 at the model's
// widths does not come here.
//
// Both directions are two chained products over one tile of rows with an
// elementwise step between them, the (rows, hidden) intermediate kept out of
// device memory except where the function itself stores it:
//
//   forward : s = x . W1        e: hb = T(s + b1), h <- hb (optional),
//                                  g = T(gelu(f32(hb)))     out = T(g . W2 + b2)
//   backward: s = do . W2^T     e: dh = T(s * gelu'(f32(h))), dh -> workspace
//                                                            dx = T(dh . W1^T)
//
// (T is the operand dtype; sums are f32.) In both, the first product
// contracts over the C columns of the row tile and the second over the hidden
// columns, so one body serves both with the weights handed over as
//   w_in  (hidden, C): row j holds the C weights that make hidden column j
//                      (forward: W1^T, the fc1 weight as torch stores it;
//                      backward: W2 as the reference stores it);
//   w_out (C, hidden): row c holds the hidden weights that make output
//                      column c (forward: W2^T, torch's fc2 weight;
//                      backward: W1 as the reference stores it).
//
// gelu is the exact form with the Abramowitz & Stegun 7.1.26 erf polynomial
// of mem_tpu/ops/mlp.py:38-51, taken from the rounded hb, and
// gelu'(h) = 0.5 (1 + erf(h / sqrt 2)) + h phi(h) (mlp.py:135-136).
//
// mlp_rows_kernel: 8 rows per block, f32 row tile and f32 output tile in
// shared memory, one warp per output column with lanes over the
// contraction. Rows past the end are staged as zeros and never written.

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

// the widths the Hopper GEMM takes for bf16 (the tensor-core widths since
// the port began): C in {128, 384, 768}, hidden a multiple of 128
bool mlp_wgmma_shape(int c, int hidden) {
  return (c == 128 || c == 384 || c == 768) && hidden > 0 && hidden % 128 == 0;
}

bool aligned16(const void* const* ptrs, int count) {
  uintptr_t all = 0;
  for (int i = 0; i < count; ++i) all |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return all % 16 == 0;
}

template <bool kBwd>
int dispatch_rows(const void* a, const void* w_in, const void* w_out, const void* b_in,
                  const void* b_out, const void* h_in, void* h_out, void* out, int rows, int c,
                  int hidden, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_rows<__nv_bfloat16, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out,
                                                    out, rows, c, hidden, stream)
                 : launch_rows<float, kBwd>(a, w_in, w_out, b_in, b_out, h_in, h_out, out,
                                            rows, c, hidden, stream);
}

}  // namespace
