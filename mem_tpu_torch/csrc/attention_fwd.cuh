// K2 forward: per-head softmax(q k^T * scale + bias_h) v on flat layouts,
// and the same kernels on head-major (B, H, N, D) layouts (K5a): the
// translation unit that includes this file picks the addressing
// (MEM_ATTENTION_HEAD_MAJOR -> kHeadMajor, layout_row_stride / layout_base
// below); the entry points are in attention_fwd.cu and attention_fwd_bhnd.cu.
// A per-file constant rather than a template argument: the flat translation
// unit then compiles exactly as if the head-major one did not exist (a
// template argument changed the flat kernels' registers and spills).
//
// Replaces mem_tpu/ops/attention.py:_fwd_flat_kernel (fused_attention_flat),
// which keeps one batch element's flat (N, H*D) q/k/v tiles and the whole
// (H, N, N) f32 bias in VMEM and loops over heads as lane slices.
//
// Shapes on the serving path: q, k, v (B, 197, 12*64) bf16, bias
// (12, 197, 197) f32 shared by the batch, scale = 1/8.
//
// f32 operands (the tests' dtype, where tensor cores would round to TF32)
// and head dims other than 64 take the scalar kernel below; bf16 at head dim
// 64 takes K3f's Hopper kernel (attention_long_fwd.cuh) at any N, and the
// other shapes above N = 256 K3f's scalar kernels.
//
// attention_fwd_flat_kernel: scalar FMAs, one block per (32-row query tile,
// head, sample), the head's whole K/V staged in shared memory with rows
// padded by one 32-bit word; each warp owns query rows, lanes take keys j =
// lane, lane + 32, ...: s = (q.k) * scale + bias (two roundings, as the
// reference), the max-subtracted exp and the f32 row sum, p = e / sum
// rounded to the operands' dtype (the TPU kernel's p.astype(v.dtype)), then
// o = p v accumulated in f32. What bounds it on the H100 is feeding the FMA
// units from shared memory. It allocates nothing and does not synchronise.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two layouts the kernels address. Flat (B, N, H*D): a head's rows are
// H*D elements apart and head h starts at column h*D. Head-major
// (B, H, N, D): rows are D apart and head h of sample b starts at
// ((b*H + h)*N)*D. Everything else (staging, fragments, arithmetic and its
// order) is shared, so the two give the same bits on the same values.
#ifdef MEM_ATTENTION_HEAD_MAJOR
constexpr bool kHeadMajor = true;
#else
constexpr bool kHeadMajor = false;
#endif

__device__ __forceinline__ int layout_row_stride(int heads, int d) {
  return kHeadMajor ? d : heads * d;
}

// c is the flat row stride heads * d
__device__ __forceinline__ int64_t layout_base(unsigned b, int h, int n, int heads, int d, int c) {
  return kHeadMajor ? (static_cast<int64_t>(b) * heads + h) * n * d
                    : static_cast<int64_t>(b) * n * c + static_cast<int64_t>(h) * d;
}

// ---------------------------------------------------------------------------
// the scalar path: f32 or bf16, any head dim
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 32;  // query rows per block

// shared-memory row stride of the staged K/V slices, in elements: one extra
// 32-bit word per row (an odd word stride when d % 4 == 0 -> no conflicts)
template <typename T>
__host__ __device__ constexpr int kv_stride(int d) {
  return d + static_cast<int>(4 / sizeof(T));
}

template <typename T>
size_t smem_bytes(int n, int d) {
  return 2 * static_cast<size_t>(n) * kv_stride<T>(d) * sizeof(T) +
         static_cast<size_t>(kWarps) * (d + n) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_flat_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int n, int heads, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = kv_stride<T>(d);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(n) * stride;
  // 2 * n * stride * sizeof(T) is a multiple of 4: the f32 area is aligned
  float* qs = reinterpret_cast<float*>(vs + static_cast<size_t>(n) * stride);
  float* ps = qs + kWarps * d;

  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, d);
  const int64_t base = layout_base(blockIdx.z, h, n, heads, d, c);

  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int j = idx / d;
    const int e = idx - j * d;
    const int64_t g = base + static_cast<int64_t>(j) * c + e;
    ks[j * stride + e] = k[g];
    vs[j * stride + e] = v[g];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = qs + warp * d;
  float* pw = ps + warp * n;
  const int row_end = min(static_cast<int>(blockIdx.x + 1) * kRowsPerBlock, n);

  for (int i = blockIdx.x * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const int64_t row = base + static_cast<int64_t>(i) * c;
    for (int e = lane; e < d; e += 32) qw[e] = to_f32(q[row + e]);
    __syncwarp();

    const float* brow = bias + (static_cast<int64_t>(h) * n + i) * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const T* kr = ks + j * stride;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(qw[e], to_f32(kr[e]), s);
      s = __fadd_rn(__fmul_rn(s, scale), brow[j]);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float ex = expf(pw[j] - mx);
      pw[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) {
      pw[j] = to_f32(from_f32<T>(__fdiv_rn(pw[j], sum)));
    }
    __syncwarp();

    for (int e = lane; e < d; e += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(pw[j], to_f32(vs[j * stride + e]), acc);
      out[row + e] = from_f32<T>(acc);
    }
    __syncwarp();  // qw / pw are rewritten by the warp's next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int b, int n, int heads, int d, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_flat_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  attention_fwd_flat_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), n, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a launch at (n, d) needs; the wrapper
// refuses shapes above the 227 KB a block may use.
long long fwd_smem_bytes(int n, int d, int is_bf16) {
  return static_cast<long long>(is_bf16 ? smem_bytes<__nv_bfloat16>(n, d)
                                        : smem_bytes<float>(n, d));
}

int dispatch_fwd(const void* q, const void* k, const void* v, const float* bias,
                 void* out, int b, int n, int heads, int d, float scale, int is_bf16,
                 cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, out, b, n, heads, d,
                                                scale, stream)
                 : launch<float>(q, k, v, bias, out, b, n, heads, d, scale,
                                        stream);
}

}  // namespace
