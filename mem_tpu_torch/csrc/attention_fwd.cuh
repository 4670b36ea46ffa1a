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
// What bounds it on the H100: per (b, h) the work is 2*N*N*D*2 = 10 MFLOP
// against 2*N*D*2 = 50 KB of K/V and 155 KB of f32 bias rows (read from L2:
// the bias is shared by the batch). With scalar FMAs the kernel is bound by
// feeding the FMA units from shared memory; on the tensor cores it is bound
// by staging K/V, the bias reads and the softmax arithmetic. Two kernels:
//
// 1. attention_fwd_flat_mma_kernel -- bf16, head dim 64, N <= 256 (the
//    serving path). One block per (64-row query tile, head, sample), four
//    warps of 16 query rows. The block stages the head's K slice (rows
//    padded to 72 elements) and V transposed (columns padded to NT*8+8) in
//    dynamic shared memory (57,600 B at N=197: above the 48 KB static
//    limit), zero past N; both paddings make the 32-bit fragment loads of a
//    warp hit 32 different banks. Each warp computes its 16 x NT*8 scores
//    with mma.sync m16n8k16 (bf16 in, f32 accumulate) and keeps them in
//    registers; adds the bias read straight from the (H, N, N) array, masks
//    keys >= N, takes the max-subtracted exp and the f32 row sum with quad
//    shuffles, divides, rounds p to bf16 (the TPU kernel's
//    p.astype(v.dtype)) and feeds p from registers as the A operand of the
//    PV mma (the accumulator layout of two adjacent 8-key tiles is the A
//    layout of one 16-key step), accumulating o in f32.
// 2. attention_fwd_flat_kernel -- every other shape and f32 operands (the
//    tests use f32, where tensor cores would round to TF32): scalar FMAs,
//    one block per (32-row query tile, head, sample), K/V staged in shared
//    memory with rows padded by one 32-bit word; each warp owns query rows,
//    lanes take keys j = lane, lane + 32, ..., same softmax order as above.
//
// Both mask the ragged edge (197 is not a multiple of 16) and allocate
// nothing and do not synchronise. TMA staging, wgmma and keeping K/V
// resident across query tiles are later work.

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
// 1. tensor-core path: bf16, D = 64, N <= 256
// ---------------------------------------------------------------------------

constexpr int kMmaD = 64;
constexpr int kMmaRows = 16 * kWarps;    // query rows per block
constexpr int kKStride = kMmaD + 8;      // 36 words: 8 key rows x 4 lanes -> 32 banks

// key tiles of 8 covering n, rounded up to an instantiated size (even: PV
// consumes two tiles per 16-key mma step)
int mma_tiles(int n) {
  const int nt = (n + 15) / 16 * 2;
  return nt <= 8 ? 8 : nt <= 16 ? 16 : nt <= 26 ? 26 : nt <= 32 ? 32 : 0;
}

// V^T row stride: NT*4 + 4 words, = 4 (mod 8) -> conflict-free fragment loads
__host__ __device__ constexpr int vt_stride(int nt) { return nt * 8 + 8; }

size_t mma_smem_bytes(int nt) {
  return static_cast<size_t>(nt) * 8 * kKStride * 2 +
         static_cast<size_t>(kMmaD) * vt_stride(nt) * 2;
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

template <int NT>
__global__ void __launch_bounds__(kThreads)
attention_fwd_flat_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out,
                              int n, int heads, float scale) {
  constexpr int kKeys = NT * 8;
  constexpr int kVts = vt_stride(NT);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [kKeys][kKStride]
  __nv_bfloat16* vt = ks + kKeys * kKStride;                     // [64][kVts]

  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, kMmaD);
  const int64_t base = layout_base(blockIdx.z, h, n, heads, kMmaD, c);

  // stage K rows and V^T, 16 B per load, zeros past n
  for (int idx = threadIdx.x; idx < kKeys * (kMmaD / 8); idx += kThreads) {
    const int j = idx / (kMmaD / 8);
    const int seg = (idx % (kMmaD / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (j < n) {
      const int64_t g = base + static_cast<int64_t>(j) * c + seg;
      kv = *reinterpret_cast<const uint4*>(k + g);
      vv = *reinterpret_cast<const uint4*>(v + g);
    }
    *reinterpret_cast<uint4*>(ks + j * kKStride + seg) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(seg + e) * kVts + j] = ve[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and key / column within a tile)
  const int t = lane % 4;   // fragment column pair
  const int r0 = blockIdx.x * kMmaRows + warp * 16;
  if (r0 >= n) return;
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool va = ra < n, vb = rb < n;

  // Q fragments of the warp's 16 rows, four 16-wide steps of the head dim
  uint32_t qa[kMmaD / 16][4];
#pragma unroll
  for (int s = 0; s < kMmaD / 16; ++s) {
    const int col = s * 16 + t * 2;
    const __nv_bfloat16* pa = q + base + static_cast<int64_t>(ra) * c + col;
    const __nv_bfloat16* pb = q + base + static_cast<int64_t>(rb) * c + col;
    qa[s][0] = va ? ld32(pa) : 0u;
    qa[s][1] = vb ? ld32(pb) : 0u;
    qa[s][2] = va ? ld32(pa + 8) : 0u;
    qa[s][3] = vb ? ld32(pb + 8) : 0u;
  }

  // scores: 16 rows x kKeys keys, f32 accumulators in registers
  float sc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const __nv_bfloat16* kr = ks + (nt * 8 + g) * kKStride + t * 2;
#pragma unroll
    for (int s = 0; s < kMmaD / 16; ++s) {
      mma_bf16(sc[nt], qa[s], ld32(kr + s * 16), ld32(kr + s * 16 + 8));
    }
  }

  // (q.k) * scale + bias (two roundings, as the reference), keys >= n masked
  const float* ba = bias + (static_cast<int64_t>(h) * n + (va ? ra : n - 1)) * n;
  const float* bb = bias + (static_cast<int64_t>(h) * n + (vb ? rb : n - 1)) * n;
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = nt * 8 + t * 2 + e;
      if (key < n) {
        sc[nt][e] = __fadd_rn(__fmul_rn(sc[nt][e], scale), ba[key]);
        sc[nt][2 + e] = __fadd_rn(__fmul_rn(sc[nt][2 + e], scale), bb[key]);
      } else {
        sc[nt][e] = sc[nt][2 + e] = -INFINITY;
      }
      mxa = fmaxf(mxa, sc[nt][e]);
      mxb = fmaxf(mxb, sc[nt][2 + e]);
    }
  }
  // a row's values sit in the 4 lanes of a quad
  mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
  mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
  mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
  mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[nt][e] = expf(sc[nt][e] - mxa);
      sc[nt][2 + e] = expf(sc[nt][2 + e] - mxb);
      suma += sc[nt][e];
      sumb += sc[nt][2 + e];
    }
  }
  suma += __shfl_xor_sync(0xffffffffu, suma, 1);
  suma += __shfl_xor_sync(0xffffffffu, suma, 2);
  sumb += __shfl_xor_sync(0xffffffffu, sumb, 1);
  sumb += __shfl_xor_sync(0xffffffffu, sumb, 2);

  // o = p v: p rounded to bf16 straight into A fragments, 16 keys per step
  float o[kMmaD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMmaD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(__fdiv_rn(sc[2 * kk][0], suma), __fdiv_rn(sc[2 * kk][1], suma)),
        pack_bf16(__fdiv_rn(sc[2 * kk][2], sumb), __fdiv_rn(sc[2 * kk][3], sumb)),
        pack_bf16(__fdiv_rn(sc[2 * kk + 1][0], suma), __fdiv_rn(sc[2 * kk + 1][1], suma)),
        pack_bf16(__fdiv_rn(sc[2 * kk + 1][2], sumb), __fdiv_rn(sc[2 * kk + 1][3], sumb))};
    const __nv_bfloat16* vr = vt + g * kVts + kk * 16 + t * 2;
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      mma_bf16(o[dn], pa, ld32(vr + dn * 8 * kVts), ld32(vr + dn * 8 * kVts + 8));
    }
  }

  __nv_bfloat16* oa = out + base + static_cast<int64_t>(ra) * c + t * 2;
  __nv_bfloat16* ob = out + base + static_cast<int64_t>(rb) * c + t * 2;
#pragma unroll
  for (int dn = 0; dn < kMmaD / 8; ++dn) {
    if (va) *reinterpret_cast<uint32_t*>(oa + dn * 8) = pack_bf16(o[dn][0], o[dn][1]);
    if (vb) *reinterpret_cast<uint32_t*>(ob + dn * 8) = pack_bf16(o[dn][2], o[dn][3]);
  }
}

template <int NT>
int launch_mma(const void* q, const void* k, const void* v, const float* bias,
               void* out, int b, int n, int heads, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(NT);
  static bool opted_in = false;   // the attribute is per kernel: set it once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_flat_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, heads, b);
  attention_fwd_flat_mma_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out),
      n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. scalar path: f32 or bf16, any head dim
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

bool use_mma(const void* q, const void* k, const void* v, const void* out,
             int n, int d, int is_bf16) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  return is_bf16 && d == kMmaD && mma_tiles(n) > 0 && ptrs % 16 == 0;
}

// Bytes of dynamic shared memory a launch at (n, d) may need (the larger of
// the two kernels' where both can take it); the wrapper refuses shapes above
// the 227 KB a block may use.
long long fwd_smem_bytes(int n, int d, int is_bf16) {
  size_t bytes = is_bf16 ? smem_bytes<__nv_bfloat16>(n, d) : smem_bytes<float>(n, d);
  if (is_bf16 && d == kMmaD && mma_tiles(n) > 0 && mma_smem_bytes(mma_tiles(n)) > bytes) {
    bytes = mma_smem_bytes(mma_tiles(n));
  }
  return static_cast<long long>(bytes);
}

int dispatch_fwd(const void* q, const void* k, const void* v, const float* bias,
                 void* out, int b, int n, int heads, int d, float scale, int is_bf16,
                 cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (use_mma(q, k, v, out, n, d, is_bf16)) {
    switch (mma_tiles(n)) {
      case 8: return launch_mma<8>(q, k, v, bias, out, b, n, heads, scale, stream);
      case 16: return launch_mma<16>(q, k, v, bias, out, b, n, heads, scale, stream);
      case 26: return launch_mma<26>(q, k, v, bias, out, b, n, heads, scale, stream);
      default: return launch_mma<32>(q, k, v, bias, out, b, n, heads, scale, stream);
    }
  }
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, out, b, n, heads, d,
                                                scale, stream)
                 : launch<float>(q, k, v, bias, out, b, n, heads, d, scale,
                                        stream);
}

}  // namespace
