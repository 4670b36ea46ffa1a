// K2 backward: dq, dk, dv and the batch-summed f32 bias gradient of
// o = softmax(q k^T * scale + bias_h) v on flat (B, N, H*D) layouts, and the
// same kernels on head-major (B, H, N, D) layouts (K5c): the translation unit
// that includes this file picks the addressing (MEM_ATTENTION_HEAD_MAJOR ->
// kHeadMajor), a per-file constant rather than a template argument, so that
// the flat translation unit compiles exactly as if the head-major one did not
// exist (a template argument changed the flat kernels' registers and spills);
// the entry points are in attention_bwd.cu and attention_bwd_bhnd.cu.
//
// Replaces mem_tpu/ops/attention.py:_bwd_flat_kernel (the VJP of
// fused_attention_flat, called from _fa_flat_bwd), which keeps one batch
// element's flat q/k/v/do tiles and the whole (H, N, N) bias in VMEM, loops
// over heads, recomputes p, and adds each sample's ds into one (H, N, N)
// output block that the sequential batch grid revisits.
//
// The numerics are that kernel's, step for step (attention.py:147-167):
//   s  = (q.k^T) * scale + bias        f32 (two roundings)
//   p  = exp(s - max) / sum            f32
//   dv = bf16(p)^T . do                f32 sum, cast to v's dtype
//   dp = do . v^T                      f32
//   ds = p * (dp - rowsum(dp * p))     f32 (the bias gradient's summand)
//   dq = (bf16(ds) . k) * scale, dk = (bf16(ds)^T . q) * scale
//   db = sum over b of ds              f32, in batch order
// ("bf16" stands for q's dtype: with f32 operands the casts are no-ops.)
//
// Training shapes: B = 64-128, N = 197, H = 12, D = 64, bf16. Per (b, h)
// the backward is five N x N x D products (~25 MFLOP) over 4 x 25 KB of
// q/k/v/do; ds alone is an N x N f32 tile (155 KB) per (b, h).
//
// What bounds it on the H100, and what the design does:
// - dk and dv sum over every query row, dq over every key, and db over the
//   batch. A Hopper block cannot carry sums across the grid the way the
//   TPU's sequential grid does, so the work of one (b, h) stays in ONE
//   block, in two phases:
//     phase 1 (query rows): p, dp, delta, ds and dq, row tile by row tile;
//       ds (f32) and p rounded to the operand dtype go to a (B, H, N, N)
//       workspace;
//     phase 2 (key columns): dk and dv from the workspace, key tile by key
//       tile (the workspace rows of this block were written by this block
//       before a __syncthreads, so they are visible, and mostly still in
//       L2).
//   No atomics: every output element is written by one thread.
// - db sums ds over the batch. Per-sample partials already sit in the
//   workspace, so a second small kernel adds them in batch order (b = 0,
//   1, ...), the TPU kernel's own order: db is bit-reproducible from run to
//   run, unlike f32 atomicAdd into a zeroed db. The cost is the workspace
//   (B*H*N*N f32: 238 MB at B=128) and one extra pass over it.
// - attention_bwd_flat_kernel runs the two phases with scalar FMAs, one row
//   (phase 1) or one key (phase 2) per warp: f32 (the tests' dtype, where
//   tensor cores would round to TF32) and head dims other than 64. bf16 at
//   D = 64 and N <= 256 runs K3b's Hopper body (attention_long_bwd.cuh)
//   instead, for K2b and K5c alike.
// It neither allocates nor synchronises: the wrapper allocates the outputs
// and the workspace.

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two layouts the kernels address (see attention_fwd.cuh): flat
// (B, N, H*D) and head-major (B, H, N, D); the arithmetic and its order are
// shared.
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
// 1. the scalar kernel: f32 or bf16, any head dim
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// staged row stride in elements: one extra 32-bit word per row (an odd word
// stride when d % 4 == 0 -> no bank conflicts)
template <typename T>
__host__ __device__ constexpr int row_stride(int d) {
  return d + static_cast<int>(4 / sizeof(T));
}

template <typename T>
size_t smem_bytes(int n, int d) {
  return 2 * static_cast<size_t>(n) * row_stride<T>(d) * sizeof(T) +
         static_cast<size_t>(kWarps) * (2 * d + 2 * n) * sizeof(float);
}

template <typename T>
__device__ void stage_pair(T* as, T* bs, const T* __restrict__ a, const T* __restrict__ b,
                           int64_t base, int n, int d, int c, int stride) {
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int j = idx / d;
    const int e = idx - j * d;
    const int64_t g = base + static_cast<int64_t>(j) * c + e;
    as[j * stride + e] = a[g];
    bs[j * stride + e] = b[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_flat_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const T* __restrict__ dout, T* __restrict__ dq,
                          T* __restrict__ dk, T* __restrict__ dv,
                          float* ds_ws, T* pc_ws, int n, int heads, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = row_stride<T>(d);
  T* as = reinterpret_cast<T*>(smem);                  // phase 1: K, phase 2: Q
  T* bs = as + static_cast<size_t>(n) * stride;        // phase 1: V, phase 2: dO
  // 2 * n * stride * sizeof(T) is a multiple of 4: the f32 area is aligned
  float* scratch = reinterpret_cast<float*>(bs + static_cast<size_t>(n) * stride);

  const int h = blockIdx.x;
  const int c = layout_row_stride(heads, d);
  const int64_t base = layout_base(blockIdx.y, h, n, heads, d, c);
  const int64_t wbase = (static_cast<int64_t>(blockIdx.y) * heads + h) * n * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xw = scratch + warp * (2 * d + 2 * n);   // the row of q
  float* yw = xw + d;                             // the row of do
  float* pw = yw + d;                             // s, then p
  float* sw = pw + n;                             // dp, then bf16(ds)

  // -- phase 1: one query row per warp at a time ----------------------------
  stage_pair(as, bs, k, v, base, n, d, c, stride);
  __syncthreads();
  for (int i = warp; i < n; i += kWarps) {
    const int64_t row = base + static_cast<int64_t>(i) * c;
    for (int e = lane; e < d; e += 32) {
      xw[e] = to_f32(q[row + e]);
      yw[e] = to_f32(dout[row + e]);
    }
    __syncwarp();
    const float* brow = bias + (static_cast<int64_t>(h) * n + i) * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const T* kr = as + j * stride;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(xw[e], to_f32(kr[e]), s);
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
    float delta = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = __fdiv_rn(pw[j], sum);
      const T* vr = bs + j * stride;
      float dp = 0.f;
      for (int e = 0; e < d; ++e) dp = fmaf(yw[e], to_f32(vr[e]), dp);
      pw[j] = p;
      sw[j] = dp;
      delta += dp * p;
    }
    delta = warp_sum(delta);
    float* dsr = ds_ws + wbase + static_cast<int64_t>(i) * n;
    T* pcr = pc_ws + wbase + static_cast<int64_t>(i) * n;
    for (int j = lane; j < n; j += 32) {
      const float ds = __fmul_rn(pw[j], __fsub_rn(sw[j], delta));
      dsr[j] = ds;
      pcr[j] = from_f32<T>(pw[j]);
      sw[j] = to_f32(from_f32<T>(ds));
    }
    __syncwarp();
    for (int e = lane; e < d; e += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(sw[j], to_f32(as[j * stride + e]), acc);
      dq[row + e] = from_f32<T>(__fmul_rn(acc, scale));
    }
    __syncwarp();   // xw / yw / pw / sw are rewritten by the warp's next row
  }
  __syncthreads();   // K/V are no longer read; the workspace rows are visible

  // -- phase 2: one key per warp at a time ----------------------------------
  stage_pair(as, bs, q, dout, base, n, d, c, stride);
  __syncthreads();
  for (int j = warp; j < n; j += kWarps) {
    const int64_t row = base + static_cast<int64_t>(j) * c;
    for (int e = lane; e < d; e += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < n; ++i) {
        const int64_t w = wbase + static_cast<int64_t>(i) * n + j;
        ak = fmaf(to_f32(from_f32<T>(ds_ws[w])), to_f32(as[i * stride + e]), ak);
        av = fmaf(to_f32(pc_ws[w]), to_f32(bs[i * stride + e]), av);
      }
      dk[row + e] = from_f32<T>(__fmul_rn(ak, scale));
      dv[row + e] = from_f32<T>(av);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, void* dq, void* dk, void* dv, float* ds_ws, void* pc_ws,
           int b, int n, int heads, int d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_flat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(heads, b);
  attention_bwd_flat_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), ds_ws, static_cast<T*>(pc_ws), n, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. db = sum over the batch of the per-sample ds, in batch order
// ---------------------------------------------------------------------------

__global__ void attention_bwd_bias_sum_kernel(const float* __restrict__ ds_ws,
                                              float* __restrict__ db, int64_t hnn, int b) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < hnn;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int bi = 0; bi < b; ++bi) s += ds_ws[bi * hnn + i];
    db[i] = s;
  }
}

int launch_bias_sum(const float* ds_ws, float* db, int b, int n, int heads,
                    cudaStream_t stream) {
  const int64_t hnn = static_cast<int64_t>(heads) * n * n;
  const int64_t blocks = (hnn + 255) / 256;
  attention_bwd_bias_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                                  stream>>>(ds_ws, db, hnn, b);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory the scalar kernel needs at (n, d); the
// wrapper refuses shapes above the 227 KB a block may use.
long long bwd_smem_bytes(int n, int d, int is_bf16) {
  return static_cast<long long>(is_bf16 ? smem_bytes<__nv_bfloat16>(n, d)
                                        : smem_bytes<float>(n, d));
}

// The scalar kernel, then the bias sum. q, k, v, dout, dq, dk, dv: one dtype
// (bf16 or f32), flat (b, n, heads*d) or head-major (b, heads, n, d) where
// MEM_ATTENTION_HEAD_MAJOR is defined; bias: (heads, n, n) f32; db:
// (heads, n, n) f32; ds_ws: (b, heads, n, n) f32 and pc_ws: (b, heads, n, n)
// in the operands' dtype, both scratch.
int dispatch_bwd(const void* q, const void* k, const void* v, const float* bias,
                 const void* dout, void* dq, void* dk, void* dv, float* db, float* ds_ws,
                 void* pc_ws, int b, int n, int heads, int d, float scale, int is_bf16,
                 cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);   // grid.y
  const int rc = is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws,
                                                 b, n, heads, d, scale, stream)
                         : launch<float>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n,
                                         heads, d, scale, stream);
  return rc != 0 ? rc : launch_bias_sum(ds_ws, db, b, n, heads, stream);
}

}  // namespace
