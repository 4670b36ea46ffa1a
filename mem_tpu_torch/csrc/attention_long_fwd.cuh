// K3f: per-head softmax(q k^T * scale + bias_h) v on flat layouts at long N,
// and the same kernels on head-major (B, H, N, D) layouts (K5b): the
// translation unit that includes this file picks the addressing
// (MEM_ATTENTION_HEAD_MAJOR -> kHeadMajor, layout_row_stride / layout_base
// below); the entry points are in attention_long_fwd.cu and
// attention_long_fwd_bhnd.cu. A per-file constant rather than a template
// argument, as in attention_fwd.cuh: the flat translation unit then compiles
// exactly as if the head-major one did not exist.
//
// Replaces mem_tpu/ops/attention.py:_fwd_flat_long_kernel
// (fused_attention_flat_long), the attention of the segmentation backbone:
// q, k, v (B, 1025, 12*64) bf16, bias (12, 1025, 1025) f32 shared by the
// batch, scale = 1/8. The TPU kernel keeps one sample's flat tiles, the whole
// bias and a full (N, N) f32 score tile per head in VMEM. No Hopper block can
// (64 query rows x 1025 keys in f32 are 262 KB), so this kernel tiles the
// keys, 64 at a time, and goes over them twice:
//
//   pass 1: s = (q.k) * scale + bias per key tile; the running row max m and
//           the row sum l of exp(s - m), rescaled when m grows;
//   pass 2: s again, p = exp(s - m) / l in f32, rounded to v's dtype, o += p v
//           with f32 accumulation.
//
// Computing q.k twice keeps the TPU kernel's roundings (attention.py:266-273:
// p is normalised in f32 and only then cast), so the result differs from the
// plain version by summation order alone; an online softmax would round the
// un-normalised exp instead.
//
// What bounds it on the H100: at B = 8 the function moves q, k, v, o (50 MB)
// plus the bias (50 MB) for 25.8 GFLOP, so bytes bound it (about 0.03 ms),
// and this first version is far from that bound: it is limited by issuing
// mma.sync and the exp/bias arithmetic from 4 warps per block with no
// overlap of staging and math. The grid is (sample, head, query tile) with
// the sample fastest, so the B blocks that read one (head, query tile) bias
// strip run together and the strip comes from device memory once and from L2
// after that. Two kernels:
//
// 1. attention_long_fwd_mma_kernel -- bf16, head dim 64 (the seg backbone).
//    One block per (sample, head, 64 query rows), four warps of 16 rows. Per
//    key tile the block stages the head's K rows (padded to 72 elements) and,
//    in pass 2, V transposed (padded to 72) in 18 KB of shared memory; both
//    paddings make a warp's 32-bit fragment loads hit 32 banks. Scores and o
//    live in registers as mma.sync m16n8k16 accumulators; p goes from the
//    score accumulators straight into the A fragments of the PV product.
// 2. attention_long_fwd_kernel -- f32 operands (nothing is rounded to TF32)
//    and other head dims up to 128: scalar FMAs, one block per (sample, head,
//    32 query rows), K/V tiles staged as f32 with rows padded by one word;
//    each warp owns 8 rows and each lane two keys of the tile.
//
// Both mask keys >= N (1025 is not a multiple of 64) and rows >= N, allocate
// nothing and do not synchronise. wgmma, TMA and a pipelined K/V ring are
// later work.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 64;            // keys per tile, both kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// a row's values sit in the 4 lanes of a quad
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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
// 1. tensor-core path: bf16, D = 64
// ---------------------------------------------------------------------------

constexpr int kMmaD = 64;
constexpr int kMmaRows = 16 * kWarps;       // query rows per block
constexpr int kNT = kTileKeys / 8;          // 8-key mma tiles per key tile
constexpr int kKStride = kMmaD + 8;         // 36 words: 8 key rows x 4 lanes -> 32 banks
constexpr int kVtStride = kTileKeys + 8;    // 36 words, the same

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

// Stage keys [j0, j0 + 64) of one head: K rows into ks and, with kWithV, V
// transposed into vt; 16 B per load, zeros past n.
template <bool kWithV>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v,
                                           __nv_bfloat16* ks, __nv_bfloat16* vt,
                                           int64_t base, int c, int j0, int n) {
  for (int idx = threadIdx.x; idx < kTileKeys * (kMmaD / 8); idx += kThreads) {
    const int j = idx / (kMmaD / 8);
    const int seg = (idx % (kMmaD / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (j0 + j < n) {
      const int64_t g = base + static_cast<int64_t>(j0 + j) * c + seg;
      kv = *reinterpret_cast<const uint4*>(k + g);
      if (kWithV) vv = *reinterpret_cast<const uint4*>(v + g);
    }
    *reinterpret_cast<uint4*>(ks + j * kKStride + seg) = kv;
    if (kWithV) {
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(seg + e) * kVtStride + j] = ve[e];
    }
  }
}

// One warp's 16 x 64 scores of a key tile: (q.k) * scale + bias (two
// roundings, as the reference), keys >= n masked to -inf.
__device__ __forceinline__ void tile_scores(float (&sc)[kNT][4],
                                            const uint32_t (&qa)[kMmaD / 16][4],
                                            const __nv_bfloat16* ks,
                                            const float* __restrict__ ba,
                                            const float* __restrict__ bb,
                                            int j0, int n, int g, int t, float scale) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const __nv_bfloat16* kr = ks + (nt * 8 + g) * kKStride + t * 2;
#pragma unroll
    for (int s = 0; s < kMmaD / 16; ++s) {
      mma_bf16(sc[nt], qa[s], ld32(kr + s * 16), ld32(kr + s * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = j0 + nt * 8 + t * 2 + e;
      if (key < n) {
        sc[nt][e] = __fadd_rn(__fmul_rn(sc[nt][e], scale), __ldg(ba + key));
        sc[nt][2 + e] = __fadd_rn(__fmul_rn(sc[nt][2 + e], scale), __ldg(bb + key));
      } else {
        sc[nt][e] = sc[nt][2 + e] = -INFINITY;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_long_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out,
                              int n, int heads, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTileKeys * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt[kMmaD * kVtStride];

  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, kMmaD);
  const int64_t base = layout_base(blockIdx.x, h, n, heads, kMmaD, c);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and key / column within an mma tile)
  const int t = lane % 4;   // fragment column pair
  // every warp stays for the staging barriers; rows >= n compute on zeros
  // (and the last row's bias) and are not written
  const int ra = blockIdx.z * kMmaRows + warp * 16 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;

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
  const float* ba = bias + (static_cast<int64_t>(h) * n + (va ? ra : n - 1)) * n;
  const float* bb = bias + (static_cast<int64_t>(h) * n + (vb ? rb : n - 1)) * n;

  const int tiles = (n + kTileKeys - 1) / kTileKeys;
  float sc[kNT][4];

  // pass 1: row max and row sum. The sums are per-thread partials under the
  // row-wide running max; key 0 is valid, so the max is finite from tile 0 on
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kTileKeys;
    __syncthreads();   // the last tile's K is done with
    stage_tile<false>(k, v, ks, vt, base, c, j0, n);
    __syncthreads();
    tile_scores(sc, qa, ks, ba, bb, j0, n, g, t, scale);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      ta = fmaxf(ta, fmaxf(sc[nt][0], sc[nt][1]));
      tb = fmaxf(tb, fmaxf(sc[nt][2], sc[nt][3]));
    }
    const float na = fmaxf(ma, quad_max(ta)), nb = fmaxf(mb, quad_max(tb));
    la *= expf(ma - na);
    lb *= expf(mb - nb);
    ma = na;
    mb = nb;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      la += expf(sc[nt][0] - ma) + expf(sc[nt][1] - ma);
      lb += expf(sc[nt][2] - mb) + expf(sc[nt][3] - mb);
    }
  }
  la = quad_sum(la);
  lb = quad_sum(lb);

  // pass 2: o = p v, p rounded to bf16 straight into A fragments (the
  // accumulator layout of two adjacent 8-key tiles is the A layout of one
  // 16-key step)
  float o[kMmaD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMmaD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kTileKeys;
    __syncthreads();
    stage_tile<true>(k, v, ks, vt, base, c, j0, n);
    __syncthreads();
    tile_scores(sc, qa, ks, ba, bb, j0, n, g, t, scale);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      sc[nt][0] = __fdiv_rn(expf(sc[nt][0] - ma), la);
      sc[nt][1] = __fdiv_rn(expf(sc[nt][1] - ma), la);
      sc[nt][2] = __fdiv_rn(expf(sc[nt][2] - mb), lb);
      sc[nt][3] = __fdiv_rn(expf(sc[nt][3] - mb), lb);
    }
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vt + g * kVtStride + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(o[dn], pa, ld32(vr + dn * 8 * kVtStride), ld32(vr + dn * 8 * kVtStride + 8));
      }
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

// ---------------------------------------------------------------------------
// 2. scalar path: f32 or bf16, head dim <= 32 * DE
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 8;                    // query rows per warp
constexpr int kRowsPerBlock = kWarps * kWarpRows;
constexpr int kMaxScalarD = 128;

// f32 words of dynamic shared memory: q rows, K and V tiles (rows padded by
// one word: an odd stride when d is even -> no conflicts), p rows
size_t scalar_smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kRowsPerBlock) * d +
                          2 * static_cast<size_t>(kTileKeys) * (d + 1) +
                          static_cast<size_t>(kRowsPerBlock) * kTileKeys);
}

template <typename T, int DE>
__global__ void __launch_bounds__(kThreads)
attention_long_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          T* __restrict__ out, int n, int heads, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = d + 1;
  float* qs = reinterpret_cast<float*>(smem);            // [32][d]
  float* ks = qs + kRowsPerBlock * d;                    // [64][d + 1]
  float* vs = ks + kTileKeys * stride;                   // [64][d + 1]
  float* ps = vs + kTileKeys * stride;                   // [32][64]

  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, d);
  const int64_t base = layout_base(blockIdx.x, h, n, heads, d, c);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.z * kRowsPerBlock;

  // rows >= n read the last row and are not written
  for (int idx = threadIdx.x; idx < kRowsPerBlock * d; idx += kThreads) {
    const int r = idx / d, e = idx - r * d;
    qs[idx] = to_f32(q[base + static_cast<int64_t>(min(row0 + r, n - 1)) * c + e]);
  }
  const float* qw = qs + warp * kWarpRows * d;
  float* pw = ps + warp * kWarpRows * kTileKeys;
  const float* brow[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    brow[r] = bias + (static_cast<int64_t>(h) * n +
                      min(row0 + warp * kWarpRows + r, n - 1)) * n;
  }

  const int tiles = (n + kTileKeys - 1) / kTileKeys;
  float m[kWarpRows], l[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float acc[kWarpRows][DE];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
    for (int ei = 0; ei < DE; ++ei) acc[r][ei] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int tile = 0; tile < tiles; ++tile) {
      const int j0 = tile * kTileKeys;
      __syncthreads();   // q is staged / the last tile is done with
      for (int idx = threadIdx.x; idx < kTileKeys * d; idx += kThreads) {
        const int j = idx / d, e = idx - j * d;
        const bool ok = j0 + j < n;
        const int64_t gi = base + static_cast<int64_t>(j0 + j) * c + e;
        ks[j * stride + e] = ok ? to_f32(k[gi]) : 0.f;
        if (pass == 1) vs[j * stride + e] = ok ? to_f32(v[gi]) : 0.f;
      }
      __syncthreads();

      // scores of the warp's 8 rows against the lane's two keys
      float s[kWarpRows][2];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) s[r][0] = s[r][1] = 0.f;
      const float* k0 = ks + lane * stride;
      const float* k1 = ks + (lane + 32) * stride;
      for (int e = 0; e < d; ++e) {
        const float a0 = k0[e], a1 = k1[e];
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          const float qe = qw[r * d + e];
          s[r][0] = fmaf(qe, a0, s[r][0]);
          s[r][1] = fmaf(qe, a1, s[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = j0 + lane + 32 * u;
          s[r][u] = key < n ? __fadd_rn(__fmul_rn(s[r][u], scale), __ldg(brow[r] + key))
                            : -INFINITY;
        }
      }

      if (pass == 0) {
        // running row max (warp-wide) and per-lane partial sums under it
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          const float mn = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
          l[r] = l[r] * expf(m[r] - mn) + expf(s[r][0] - mn) + expf(s[r][1] - mn);
          m[r] = mn;
        }
      } else {
        // p = exp(s - m) / l rounded to T, then o += p v: lanes own columns
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            pw[r * kTileKeys + lane + 32 * u] =
                to_f32(from_f32<T>(__fdiv_rn(expf(s[r][u] - m[r]), l[r])));
          }
        }
        __syncwarp();
        for (int j = 0; j < kTileKeys; ++j) {
          float ve[DE];
#pragma unroll
          for (int ei = 0; ei < DE; ++ei) {
            const int e = lane + 32 * ei;
            ve[ei] = e < d ? vs[j * stride + e] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            const float p = pw[r * kTileKeys + j];
#pragma unroll
            for (int ei = 0; ei < DE; ++ei) acc[r][ei] = fmaf(p, ve[ei], acc[r][ei]);
          }
        }
        __syncwarp();   // pw is rewritten at the next tile
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) l[r] = warp_sum(l[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int i = row0 + warp * kWarpRows + r;
    if (i >= n) continue;
#pragma unroll
    for (int ei = 0; ei < DE; ++ei) {
      const int e = lane + 32 * ei;
      if (e < d) out[base + static_cast<int64_t>(i) * c + e] = from_f32<T>(acc[r][ei]);
    }
  }
}

template <typename T, int DE>
int launch_scalar(const void* q, const void* k, const void* v, const float* bias,
                  void* out, int b, int n, int heads, int d, float scale,
                  cudaStream_t stream) {
  const size_t smem = scalar_smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_long_fwd_kernel<T, DE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b, heads, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  attention_long_fwd_kernel<T, DE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), n, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scalar_d(const void* q, const void* k, const void* v, const float* bias,
                    void* out, int b, int n, int heads, int d, float scale,
                    cudaStream_t stream) {
  if (d <= 32) return launch_scalar<T, 1>(q, k, v, bias, out, b, n, heads, d, scale, stream);
  if (d <= 64) return launch_scalar<T, 2>(q, k, v, bias, out, b, n, heads, d, scale, stream);
  return launch_scalar<T, 4>(q, k, v, bias, out, b, n, heads, d, scale, stream);
}

bool use_mma(const void* q, const void* k, const void* v, const void* out,
             int d, int is_bf16) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  return is_bf16 && d == kMmaD && ptrs % 16 == 0;
}

// q, k, v, out in the translation unit's layout, one dtype (bf16 or f32);
// bias: (heads, n, n) f32.
int dispatch_long_fwd(const void* q, const void* k, const void* v, const float* bias,
                      void* out, int b, int n, int heads, int d, float scale, int is_bf16,
                      cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (heads > 65535 || d < 1 || d > kMaxScalarD) return static_cast<int>(cudaErrorInvalidValue);
  if (use_mma(q, k, v, out, d, is_bf16)) {
    if ((n + kMmaRows - 1) / kMmaRows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(b, heads, (n + kMmaRows - 1) / kMmaRows);
    attention_long_fwd_mma_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out),
        n, heads, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if ((n + kRowsPerBlock - 1) / kRowsPerBlock > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return is_bf16 ? launch_scalar_d<__nv_bfloat16>(q, k, v, bias, out, b, n, heads, d, scale,
                                                   stream)
                 : launch_scalar_d<float>(q, k, v, bias, out, b, n, heads, d, scale, stream);
}

}  // namespace
