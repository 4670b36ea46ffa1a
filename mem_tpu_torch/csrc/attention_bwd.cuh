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
// - Feeding the products: attention_bwd_flat_mma_kernel (bf16, D = 64,
//   N <= 256; K2b's mma.sync tensor-core kernel, which no model path launches
//   any more: K2b and K5c at those shapes run K3b's Hopper body,
//   attention_long_bwd.cuh; this kernel stays, behind
//   attention_bwd.cu's mem_attention_bwd_flat_mma, as the yardstick X3,
//   attention_bwd_pair.cu, is held to bit for bit) runs all five products on
//   the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), 8 warps per
//   block. K and V are staged row-major and K^T, Q^T and dO^T transposed
//   in dynamic shared memory (140 KB at N=197), padded so the 32-bit
//   fragment loads of a warp hit 32 banks. Phase 1 keeps a warp's 16 x
//   NT*8 probability tile in registers, recomputes dp once for delta and
//   once for ds (it cannot also hold dp: 255 registers), and feeds bf16(ds)
//   from registers as the A operand of dq. Phase 2 reads p and ds of 16
//   keys x 16 queries from the workspace as transposed A fragments.
//   attention_bwd_flat_kernel (every other shape, and f32: the tests'
//   dtype, where tensor cores would round to TF32) is the same two phases
//   with scalar FMAs, one row (phase 1) or one key (phase 2) per warp.
// Neither allocates nor synchronises: the wrapper allocates the outputs
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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
// 1. tensor-core path: bf16, D = 64, N <= 256
// ---------------------------------------------------------------------------

constexpr int kMmaD = 64;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRowStride = kMmaD + 8;   // K, V rows: 36 words -> 8 rows x 4 lanes on 32 banks

// key tiles of 8 covering n, rounded up to an instantiated size (even: a
// 16-wide mma step consumes two tiles)
int mma_tiles(int n) {
  const int nt = (n + 15) / 16 * 2;
  return nt <= 8 ? 8 : nt <= 16 ? 16 : nt <= 26 ? 26 : nt <= 32 ? 32 : 0;
}

// transposed (d-major) row stride: NT*4 + 4 words, = 4 (mod 8) -> the
// fragment loads of 8 rows x 4 lanes hit 32 different banks
__host__ __device__ constexpr int t_stride(int nt) { return nt * 8 + 8; }

size_t mma_smem_bytes(int nt) {
  return 2 * static_cast<size_t>(nt) * 8 * kRowStride * 2 +
         3 * static_cast<size_t>(kMmaD) * t_stride(nt) * 2;
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&x));
}

// A fragments of 16 rows x 64 columns of a flat (N, H*64) bf16 operand
__device__ __forceinline__ void load_rows(uint32_t (&f)[kMmaD / 16][4],
                                          const __nv_bfloat16* x, int64_t base, int c,
                                          int ra, int rb, bool va, bool vb, int t) {
#pragma unroll
  for (int s = 0; s < kMmaD / 16; ++s) {
    const int col = s * 16 + t * 2;
    const __nv_bfloat16* pa = x + base + static_cast<int64_t>(ra) * c + col;
    const __nv_bfloat16* pb = x + base + static_cast<int64_t>(rb) * c + col;
    f[s][0] = va ? ld32(pa) : 0u;
    f[s][1] = vb ? ld32(pb) : 0u;
    f[s][2] = va ? ld32(pa + 8) : 0u;
    f[s][3] = vb ? ld32(pb + 8) : 0u;
  }
}

// ds_ws / pc_ws are written in phase 1 and read back in phase 2 by the same
// block: plain (not const __restrict__) pointers, so no read goes through
// the non-coherent cache.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_flat_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv,
                              float* ds_ws, __nv_bfloat16* pc_ws,
                              int n, int heads, float scale) {
  constexpr int kKeys = NT * 8;
  constexpr int kTs = t_stride(NT);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [kKeys][kRowStride]
  __nv_bfloat16* vs = ks + kKeys * kRowStride;                   // [kKeys][kRowStride]
  __nv_bfloat16* kt = vs + kKeys * kRowStride;                   // [64][kTs]
  __nv_bfloat16* qt = kt + kMmaD * kTs;                          // [64][kTs]
  __nv_bfloat16* dot = qt + kMmaD * kTs;                         // [64][kTs]

  const int h = blockIdx.x;
  const int c = layout_row_stride(heads, kMmaD);
  const int64_t base = layout_base(blockIdx.y, h, n, heads, kMmaD, c);
  const int64_t wbase = (static_cast<int64_t>(blockIdx.y) * heads + h) * n * n;

  // stage K, V rows and K^T, Q^T, dO^T, 16 B per load, zeros past n
  for (int idx = threadIdx.x; idx < kKeys * (kMmaD / 8); idx += kMmaThreads) {
    const int j = idx / (kMmaD / 8);
    const int seg = (idx % (kMmaD / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv, qv = kv, dv4 = kv;
    if (j < n) {
      const int64_t g = base + static_cast<int64_t>(j) * c + seg;
      kv = *reinterpret_cast<const uint4*>(k + g);
      vv = *reinterpret_cast<const uint4*>(v + g);
      qv = *reinterpret_cast<const uint4*>(q + g);
      dv4 = *reinterpret_cast<const uint4*>(dout + g);
    }
    *reinterpret_cast<uint4*>(ks + j * kRowStride + seg) = kv;
    *reinterpret_cast<uint4*>(vs + j * kRowStride + seg) = vv;
    const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kt[(seg + e) * kTs + j] = ke[e];
      qt[(seg + e) * kTs + j] = qe[e];
      dot[(seg + e) * kTs + j] = de[e];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and key / column within a tile)
  const int t = lane % 4;   // fragment column pair
  const int tiles = (n + 15) / 16;

  // -- phase 1: one 16-row query tile per warp at a time --------------------
  for (int rt = warp; rt < tiles; rt += kMmaWarps) {
    const int ra = rt * 16 + g, rb = ra + 8;
    const bool va = ra < n, vb = rb < n;
    uint32_t fa[kMmaD / 16][4];
    load_rows(fa, q, base, c, ra, rb, va, vb, t);

    // s = q k^T (f32 accumulators), then * scale + bias, keys >= n masked
    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * kRowStride + t * 2;
#pragma unroll
      for (int s = 0; s < kMmaD / 16; ++s) {
        mma_bf16(p[nt], fa[s], ld32(kr + s * 16), ld32(kr + s * 16 + 8));
      }
    }
    const float* ba = bias + (static_cast<int64_t>(h) * n + (va ? ra : n - 1)) * n;
    const float* bb = bias + (static_cast<int64_t>(h) * n + (vb ? rb : n - 1)) * n;
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = nt * 8 + t * 2 + e;
        if (key < n) {
          p[nt][e] = __fadd_rn(__fmul_rn(p[nt][e], scale), ba[key]);
          p[nt][2 + e] = __fadd_rn(__fmul_rn(p[nt][2 + e], scale), bb[key]);
        } else {
          p[nt][e] = p[nt][2 + e] = -INFINITY;
        }
        mxa = fmaxf(mxa, p[nt][e]);
        mxb = fmaxf(mxb, p[nt][2 + e]);
      }
    }
    mxa = quad_max(mxa);   // a row's values sit in the 4 lanes of a quad
    mxb = quad_max(mxb);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = expf(p[nt][e] - mxa);
        p[nt][2 + e] = expf(p[nt][2 + e] - mxb);
        suma += p[nt][e];
        sumb += p[nt][2 + e];
      }
    }
    suma = quad_sum(suma);
    sumb = quad_sum(sumb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      p[nt][0] = __fdiv_rn(p[nt][0], suma);
      p[nt][1] = __fdiv_rn(p[nt][1], suma);
      p[nt][2] = __fdiv_rn(p[nt][2], sumb);
      p[nt][3] = __fdiv_rn(p[nt][3], sumb);
    }

    // delta = rowsum(dp * p), dp = do v^T recomputed tile by tile
    load_rows(fa, dout, base, c, ra, rb, va, vb, t);
    float dla = 0.f, dlb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* vr = vs + (nt * 8 + g) * kRowStride + t * 2;
#pragma unroll
      for (int s = 0; s < kMmaD / 16; ++s) {
        mma_bf16(dp, fa[s], ld32(vr + s * 16), ld32(vr + s * 16 + 8));
      }
      dla += dp[0] * p[nt][0] + dp[1] * p[nt][1];
      dlb += dp[2] * p[nt][2] + dp[3] * p[nt][3];
    }
    dla = quad_sum(dla);
    dlb = quad_sum(dlb);

    // ds = p (dp - delta): to the workspace with bf16(p), and bf16(ds)
    // straight into the A fragments of dq = ds k, 16 keys per step
    float acc[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    float* dsa = ds_ws + wbase + static_cast<int64_t>(va ? ra : 0) * n;
    float* dsb = ds_ws + wbase + static_cast<int64_t>(vb ? rb : 0) * n;
    __nv_bfloat16* pca = pc_ws + wbase + static_cast<int64_t>(va ? ra : 0) * n;
    __nv_bfloat16* pcb = pc_ws + wbase + static_cast<int64_t>(vb ? rb : 0) * n;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* vr = vs + (nt * 8 + g) * kRowStride + t * 2;
#pragma unroll
        for (int s = 0; s < kMmaD / 16; ++s) {
          mma_bf16(dp, fa[s], ld32(vr + s * 16), ld32(vr + s * 16 + 8));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ds[half][e] = __fmul_rn(p[nt][e], __fsub_rn(dp[e], dla));
          ds[half][2 + e] = __fmul_rn(p[nt][2 + e], __fsub_rn(dp[2 + e], dlb));
          const int key = nt * 8 + t * 2 + e;
          if (key < n) {
            if (va) {
              dsa[key] = ds[half][e];
              pca[key] = __float2bfloat16_rn(p[nt][e]);
            }
            if (vb) {
              dsb[key] = ds[half][2 + e];
              pcb[key] = __float2bfloat16_rn(p[nt][2 + e]);
            }
          }
        }
      }
      const uint32_t a[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      const __nv_bfloat16* kr = kt + g * kTs + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(acc[dn], a, ld32(kr + dn * 8 * kTs), ld32(kr + dn * 8 * kTs + 8));
      }
    }
    __nv_bfloat16* oa = dq + base + static_cast<int64_t>(ra) * c + t * 2;
    __nv_bfloat16* ob = dq + base + static_cast<int64_t>(rb) * c + t * 2;
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      if (va) {
        *reinterpret_cast<uint32_t*>(oa + dn * 8) =
            pack_bf16(__fmul_rn(acc[dn][0], scale), __fmul_rn(acc[dn][1], scale));
      }
      if (vb) {
        *reinterpret_cast<uint32_t*>(ob + dn * 8) =
            pack_bf16(__fmul_rn(acc[dn][2], scale), __fmul_rn(acc[dn][3], scale));
      }
    }
  }
  __syncthreads();   // the block's workspace rows are complete and visible

  // -- phase 2: one 16-key tile per warp at a time: dv = p^T do, dk = ds^T q
  for (int ct = warp; ct < tiles; ct += kMmaWarps) {
    const int ja = ct * 16 + g, jb = ja + 8;
    const bool ka = ja < n, kb = jb < n;
    float accv[kMmaD / 8][4], acck[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      accv[dn][0] = accv[dn][1] = accv[dn][2] = accv[dn][3] = 0.f;
      acck[dn][0] = acck[dn][1] = acck[dn][2] = acck[dn][3] = 0.f;
    }
    for (int kk = 0; kk < NT / 2; ++kk) {
      // A[key][query] = ws[query][key]: queries i, i+1 (a0/a1) and i+8,
      // i+9 (a2/a3), keys ja (a0/a2) and jb (a1/a3); zero past n
      const int i = kk * 16 + t * 2;
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = i + (r >> 1) * 8;
        const int kj = (r & 1) ? jb : ja;
        const bool kv = (r & 1) ? kb : ka;
        uint32_t plo = 0u, phi = 0u;
        float slo = 0.f, shi = 0.f;
        if (kv && qi < n) {
          plo = bits(pc_ws[wbase + static_cast<int64_t>(qi) * n + kj]);
          slo = ds_ws[wbase + static_cast<int64_t>(qi) * n + kj];
        }
        if (kv && qi + 1 < n) {
          phi = bits(pc_ws[wbase + static_cast<int64_t>(qi + 1) * n + kj]);
          shi = ds_ws[wbase + static_cast<int64_t>(qi + 1) * n + kj];
        }
        pa[r] = plo | (phi << 16);
        sa[r] = pack_bf16(slo, shi);
      }
      const __nv_bfloat16* dr = dot + g * kTs + kk * 16 + t * 2;
      const __nv_bfloat16* qr = qt + g * kTs + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(accv[dn], pa, ld32(dr + dn * 8 * kTs), ld32(dr + dn * 8 * kTs + 8));
        mma_bf16(acck[dn], sa, ld32(qr + dn * 8 * kTs), ld32(qr + dn * 8 * kTs + 8));
      }
    }
    const int64_t oa = base + static_cast<int64_t>(ja) * c + t * 2;
    const int64_t ob = base + static_cast<int64_t>(jb) * c + t * 2;
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      if (ka) {
        *reinterpret_cast<uint32_t*>(dv + oa + dn * 8) = pack_bf16(accv[dn][0], accv[dn][1]);
        *reinterpret_cast<uint32_t*>(dk + oa + dn * 8) =
            pack_bf16(__fmul_rn(acck[dn][0], scale), __fmul_rn(acck[dn][1], scale));
      }
      if (kb) {
        *reinterpret_cast<uint32_t*>(dv + ob + dn * 8) = pack_bf16(accv[dn][2], accv[dn][3]);
        *reinterpret_cast<uint32_t*>(dk + ob + dn * 8) =
            pack_bf16(__fmul_rn(acck[dn][2], scale), __fmul_rn(acck[dn][3], scale));
      }
    }
  }
}

template <int NT>
int launch_mma(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, void* dq, void* dk, void* dv, float* ds_ws,
               void* pc_ws, int b, int n, int heads, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(NT);
  static bool opted_in = false;   // the attribute is per kernel: set it once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_flat_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(heads, b);
  attention_bwd_flat_mma_kernel<NT><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), ds_ws, static_cast<__nv_bfloat16*>(pc_ws),
      n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. scalar path: f32 or bf16, any head dim
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
// 3. db = sum over the batch of the per-sample ds, in batch order
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

bool use_mma(const void* const* ptrs, int count, int n, int d, int is_bf16) {
  uintptr_t all = 0;
  for (int i = 0; i < count; ++i) all |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return is_bf16 && d == kMmaD && mma_tiles(n) > 0 && all % 16 == 0;
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
