// K3b: the backward of K3f. dq, dk, dv and the batch-summed f32 bias gradient
// of o = softmax(q k^T * scale + bias_h) v on flat (B, N, H*D) layouts at
// long N, and the same kernels on head-major (B, H, N, D) layouts (K5d, K5e):
// the translation unit that includes this file picks the addressing
// (MEM_ATTENTION_HEAD_MAJOR -> kHeadMajor, layout_row_stride / layout_base
// below), a per-file constant as in attention_bwd.cuh; the entry points are in
// attention_long_bwd.cu and attention_long_bwd_bhnd.cu.
//
// Replaces mem_tpu/ops/attention.py:_bwd_flat_long_kernel (the VJP of
// fused_attention_flat_long, called from _fa_flat_long_bwd), the attention
// backward of the segmentation backbone: q, k, v, do (B, 1025, 12*64) bf16,
// bias (12, 1025, 1025) f32, B = 8-16. The TPU kernel pads N to blocks of 256
// query rows, keeps a block's (256, Np) f32 score tile per head in VMEM,
// writes dk/dv as one partial per query block (summed outside) and adds ds
// into a db block that its sequential batch axis revisits. None of the three
// carries over: no Hopper block holds such a score tile, and a Hopper grid has
// no order. What is kept is the arithmetic (attention.py:300-322):
//   s  = (q.k^T) * scale + bias        f32 (two roundings)
//   p  = exp(s - max) / sum            f32
//   dv = bf16(p)^T . do                f32 sum, cast to v's dtype
//   dp = do . v^T                      f32
//   ds = p * (dp - rowsum(dp * p))     f32 (the bias gradient's summand)
//   dq = (bf16(ds) . k) * scale, dk = (bf16(ds)^T . q) * scale
//   db = sum over b of ds              f32, in batch order
// ("bf16" stands for q's dtype: with f32 operands the casts are no-ops.) The
// TPU kernel also rounds each 256-row dk/dv partial to the operand dtype
// before the partials are summed; here dk and dv are summed in f32 over all
// rows and rounded once. Any N is taken as it is: the ragged last tile is
// masked, nothing is padded.
//
// What bounds it on the H100, and what the design does. At B = 16 the
// function moves q, k, v, do, dq, dk, dv (176 MB) and the bias and db (101
// MB) for five N x N x D products per (b, h) (129 GFLOP): about 0.13 ms of
// tensor-core time against 0.08 ms of memory time, so operations bound it.
// Three sums cross any tile a block can hold: dq over the keys, dk/dv over the
// query rows, db over the batch. The tensor-core path keeps each in one
// thread's registers, with no float atomics, by going over the scores from
// both sides and recomputing them from row statistics instead of storing p:
//
// 1. attention_long_bwd_rows_mma_kernel, one block per (sample, head, 64
//    query rows), keys in tiles of 64, two passes (as K3f):
//      pass A: s and dp per key tile; the running row max m, the row sum l of
//              exp(s - m) and t = sum exp(s - m) dp, both rescaled when m
//              grows; delta = t / l;
//      pass B: s and dp again, p = exp(s - m) / l, ds = p (dp - delta) in
//              f32 to a (B, H, N, N) workspace, and bf16(ds) straight from
//              the accumulators into the A fragments of dq += ds k.
//    m, l and delta go to a (3, B, H, N) f32 statistics array.
// 2. attention_long_bwd_cols_mma_kernel, one block per (sample, head, 64
//    keys), query rows in tiles of 64: the transposed score tile k q^T and
//    v do^T from the same mma (keys as rows), p and ds rebuilt from the
//    statistics and the transposed bias, and bf16(p), bf16(ds) from the
//    accumulators into the A fragments of dv += p^T do and dk += ds^T q.
//    Nothing of size N x N is read here except the bias.
// 3. attention_long_bwd_bias_sum_kernel adds the workspace's per-sample ds in
//    batch order (b = 0, 1, ...), the TPU kernel's own order: db is
//    bit-reproducible from run to run.
// The price: nine products instead of five, and the f32 ds workspace (0.81 GB
// at B = 16, written once and read once: 1.6 GB of traffic, about 0.5 ms).
// Storing bf16(p) as well (the design of K2b) would save two products in
// step 2 and cost another 0.4 GB and column reads that do not coalesce.
// Both grids run the sample fastest, so the blocks that read one bias strip
// run together and it comes from device memory once.
//
// The scalar path (f32 operands, where tensor cores would round to TF32, and
// head dims other than 64, up to 128) is K2b's scalar kernel cut in two:
// attention_long_bwd_rows_kernel (one query row per warp at a time, the
// row's s, p, dp in shared memory, ds and p rounded to the operand dtype to
// (B, H, N, N) workspaces) and attention_long_bwd_cols_kernel (one key per
// warp at a time, dk and dv from the workspaces), reading K, V, Q and dO from
// device memory through the caches.
//
// No kernel allocates or synchronises: the wrapper allocates the outputs, the
// workspaces and the statistics. wgmma, TMA, a pipelined tile ring and a
// forward that keeps m and l are later work.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                // keys (rows kernel) or queries (cols kernel) per tile

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

// The two layouts the kernels address (as in attention_long_fwd.cuh). Flat
// (B, N, H*D): a head's rows are H*D elements apart and head h starts at
// column h*D. Head-major (B, H, N, D): rows are D apart and head h of sample
// b starts at ((b*H + h)*N)*D. The workspaces, the statistics and the bias
// are (B, H, N, N), (3, B, H, N) and (H, N, N) in both.
#ifdef MEM_ATTENTION_HEAD_MAJOR
constexpr bool kHeadMajor = true;
#else
constexpr bool kHeadMajor = false;
#endif

__device__ __forceinline__ int layout_row_stride(int heads, int d) {
  return kHeadMajor ? d : heads * d;
}

// c is the flat row stride heads * d
__device__ __forceinline__ int64_t layout_base(int b, int h, int n, int heads, int d, int c) {
  return kHeadMajor ? (static_cast<int64_t>(b) * heads + h) * n * d
                    : static_cast<int64_t>(b) * n * c + static_cast<int64_t>(h) * d;
}

// ---------------------------------------------------------------------------
// 1. tensor-core path: bf16, D = 64
// ---------------------------------------------------------------------------

constexpr int kMmaD = 64;
constexpr int kNT = kTile / 8;           // 8-column mma tiles per 64-wide tile
// Row stride of every staged tile, row-major ([row][d]) or transposed
// ([d][row]): 64 + 8 elements = 36 words, so the 32-bit fragment loads of 8
// rows x 4 lanes hit 32 banks.
constexpr int kStride = kTile + 8;
static_assert(kMmaD == kTile, "one stride serves both layouts");

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

// A fragments of rows ra, rb (= ra + 8) x 64 columns of one head of a bf16
// operand whose rows are c elements apart; zeros for a row past n
__device__ __forceinline__ void load_rows(uint32_t (&f)[kMmaD / 16][4],
                                          const __nv_bfloat16* __restrict__ x, int64_t base,
                                          int c, int ra, int rb, bool va, bool vb, int t) {
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

// Stage rows [r0, r0 + 64) of one head of two operands x and y: x
// row-major into xs, y row-major into ys, and, where the pointer is given,
// x transposed into xt and y transposed into yt; 16 B per load, zeros past n.
template <bool kXt, bool kYt>
__device__ __forceinline__ void stage_pair(const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ y,
                                           __nv_bfloat16* xs, __nv_bfloat16* ys,
                                           __nv_bfloat16* xt, __nv_bfloat16* yt,
                                           int64_t base, int c, int r0, int n) {
  for (int idx = threadIdx.x; idx < kTile * (kMmaD / 8); idx += kThreads) {
    const int j = idx / (kMmaD / 8);
    const int seg = (idx % (kMmaD / 8)) * 8;
    uint4 xv = make_uint4(0, 0, 0, 0), yv = make_uint4(0, 0, 0, 0);
    if (r0 + j < n) {
      const int64_t g = base + static_cast<int64_t>(r0 + j) * c + seg;
      xv = *reinterpret_cast<const uint4*>(x + g);
      yv = *reinterpret_cast<const uint4*>(y + g);
    }
    *reinterpret_cast<uint4*>(xs + j * kStride + seg) = xv;
    *reinterpret_cast<uint4*>(ys + j * kStride + seg) = yv;
    if (kXt) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) xt[(seg + e) * kStride + j] = xe[e];
    }
    if (kYt) {
      const __nv_bfloat16* ye = reinterpret_cast<const __nv_bfloat16*>(&yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) yt[(seg + e) * kStride + j] = ye[e];
    }
  }
}

// One warp's 16 x 8 product tile a . rows^T against the staged rows
// [nt * 8, nt * 8 + 8) of xs (row-major [row][d])
__device__ __forceinline__ void tile_product(float (&acc)[4],
                                             const uint32_t (&a)[kMmaD / 16][4],
                                             const __nv_bfloat16* xs, int nt, int g, int t) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  const __nv_bfloat16* xr = xs + (nt * 8 + g) * kStride + t * 2;
#pragma unroll
  for (int s = 0; s < kMmaD / 16; ++s) {
    mma_bf16(acc, a[s], ld32(xr + s * 16), ld32(xr + s * 16 + 8));
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
    tile_product(sc[nt], qa, ks, nt, g, t);
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

// stats: (3, B, H, N) f32 = row max m, row sum l, delta
__global__ void __launch_bounds__(kThreads)
attention_long_bwd_rows_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const __nv_bfloat16* __restrict__ dout,
                                   __nv_bfloat16* __restrict__ dq,
                                   float* __restrict__ ds_ws, float* __restrict__ stats,
                                   int n, int heads, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kStride];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kStride];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 kt[kMmaD * kStride];   // [d][key]

  const int bi = blockIdx.x;
  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, kMmaD);
  const int64_t base = layout_base(bi, h, n, heads, kMmaD, c);
  const int64_t bh = static_cast<int64_t>(bi) * heads + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and key / column within an mma tile)
  const int t = lane % 4;   // fragment column pair
  // every warp stays for the staging barriers; rows >= n compute on zeros
  // (and the last row's bias) and write nothing
  const int ra = blockIdx.z * kTile + warp * 16 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;

  uint32_t qa[kMmaD / 16][4], da[kMmaD / 16][4];
  load_rows(qa, q, base, c, ra, rb, va, vb, t);
  load_rows(da, dout, base, c, ra, rb, va, vb, t);
  const float* ba = bias + (static_cast<int64_t>(h) * n + (va ? ra : n - 1)) * n;
  const float* bb = bias + (static_cast<int64_t>(h) * n + (vb ? rb : n - 1)) * n;

  const int tiles = (n + kTile - 1) / kTile;
  float sc[kNT][4];

  // pass A: m, l and t = sum exp(s - m) dp. The sums are per-thread partials
  // under the row-wide running max; key 0 is valid, so the max is finite from
  // tile 0 on. Keys >= n: exp(-inf - m) = 0 and dp = 0 (V staged as zeros).
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, ta = 0.f, tb = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kTile;
    __syncthreads();   // the last tile is done with
    stage_pair<false, false>(k, v, ks, vs, nullptr, nullptr, base, c, j0, n);
    __syncthreads();
    tile_scores(sc, qa, ks, ba, bb, j0, n, g, t, scale);
    float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      xa = fmaxf(xa, fmaxf(sc[nt][0], sc[nt][1]));
      xb = fmaxf(xb, fmaxf(sc[nt][2], sc[nt][3]));
    }
    const float na = fmaxf(ma, quad_max(xa)), nb = fmaxf(mb, quad_max(xb));
    const float fa = expf(ma - na), fb = expf(mb - nb);
    la *= fa;
    ta *= fa;
    lb *= fb;
    tb *= fb;
    ma = na;
    mb = nb;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float dp[4];
      tile_product(dp, da, vs, nt, g, t);
      const float e0 = expf(sc[nt][0] - ma), e1 = expf(sc[nt][1] - ma);
      const float e2 = expf(sc[nt][2] - mb), e3 = expf(sc[nt][3] - mb);
      la += e0 + e1;
      lb += e2 + e3;
      ta += e0 * dp[0] + e1 * dp[1];
      tb += e2 * dp[2] + e3 * dp[3];
    }
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
  const float dla = __fdiv_rn(quad_sum(ta), la), dlb = __fdiv_rn(quad_sum(tb), lb);
  if (t == 0) {
    const int64_t plane = static_cast<int64_t>(gridDim.x) * heads * n;
    if (va) {
      float* st = stats + bh * n + ra;
      st[0] = ma;
      st[plane] = la;
      st[2 * plane] = dla;
    }
    if (vb) {
      float* st = stats + bh * n + rb;
      st[0] = mb;
      st[plane] = lb;
      st[2 * plane] = dlb;
    }
  }

  // pass B: ds to the workspace, and bf16(ds) from the accumulators into the A
  // fragments of dq = ds k (two adjacent 8-key tiles are one 16-key step)
  float acc[kMmaD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMmaD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float* dsa = ds_ws + (bh * n + (va ? ra : 0)) * n;
  float* dsb = ds_ws + (bh * n + (vb ? rb : 0)) * n;
  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * kTile;
    __syncthreads();
    stage_pair<true, false>(k, v, ks, vs, kt, nullptr, base, c, j0, n);
    __syncthreads();
    tile_scores(sc, qa, ks, ba, bb, j0, n, g, t, scale);
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        float dp[4];
        tile_product(dp, da, vs, nt, g, t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pa = __fdiv_rn(expf(sc[nt][e] - ma), la);
          const float pb = __fdiv_rn(expf(sc[nt][2 + e] - mb), lb);
          ds[half][e] = __fmul_rn(pa, __fsub_rn(dp[e], dla));
          ds[half][2 + e] = __fmul_rn(pb, __fsub_rn(dp[2 + e], dlb));
          const int key = j0 + nt * 8 + t * 2 + e;
          if (key < n) {
            if (va) dsa[key] = ds[half][e];
            if (vb) dsb[key] = ds[half][2 + e];
          }
        }
      }
      const uint32_t a[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      const __nv_bfloat16* kr = kt + g * kStride + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(acc[dn], a, ld32(kr + dn * 8 * kStride), ld32(kr + dn * 8 * kStride + 8));
      }
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

__global__ void __launch_bounds__(kThreads)
attention_long_bwd_cols_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ stats,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv,
                                   int n, int heads, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kStride];    // [query][d]
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kStride];   // [query][d]
  __shared__ __align__(16) __nv_bfloat16 qt[kMmaD * kStride];    // [d][query]
  __shared__ __align__(16) __nv_bfloat16 dot[kMmaD * kStride];   // [d][query]
  __shared__ float sm[kTile], sl[kTile], sd[kTile];              // the tile's m, l, delta

  const int bi = blockIdx.x;
  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, kMmaD);
  const int64_t base = layout_base(bi, h, n, heads, kMmaD, c);
  const int64_t bh = static_cast<int64_t>(bi) * heads + h;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * heads * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row: a key
  const int t = lane % 4;   // fragment column pair: two queries
  const int ja = blockIdx.z * kTile + warp * 16 + g, jb = ja + 8;
  const bool ka = ja < n, kb = jb < n;

  // the warp's 16 keys as A fragments: K for s^T = k q^T, V for dp^T = v do^T
  uint32_t kf[kMmaD / 16][4], vf[kMmaD / 16][4];
  load_rows(kf, k, base, c, ja, jb, ka, kb, t);
  load_rows(vf, v, base, c, ja, jb, ka, kb, t);
  // bias[h][query][key]: the thread walks down two columns
  const float* bcol = bias + static_cast<int64_t>(h) * n * n;

  float accv[kMmaD / 8][4], acck[kMmaD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMmaD / 8; ++dn) {
    accv[dn][0] = accv[dn][1] = accv[dn][2] = accv[dn][3] = 0.f;
    acck[dn][0] = acck[dn][1] = acck[dn][2] = acck[dn][3] = 0.f;
  }

  const int tiles = (n + kTile - 1) / kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const int i0 = tile * kTile;
    __syncthreads();   // the last tile is done with
    stage_pair<true, true>(q, dout, qs, dos, qt, dot, base, c, i0, n);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < n;
      const float* st = stats + bh * n + (ok ? i : 0);
      sm[threadIdx.x] = ok ? st[0] : 0.f;
      sl[threadIdx.x] = ok ? st[plane] : 1.f;
      sd[threadIdx.x] = ok ? st[2 * plane] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      float p[2][4], ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        float st[4], dp[4];
        tile_product(st, kf, qs, nt, g, t);
        tile_product(dp, vf, dos, nt, g, t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int il = nt * 8 + t * 2 + e;   // the query, within the tile
          const int i = i0 + il;
          const bool vi = i < n;
          const float m = sm[il], l = sl[il], dl = sd[il];
          // queries >= n and keys >= n: p = ds = 0, the bias is not read
          float pa = 0.f, pb = 0.f;
          if (vi && ka) {
            const float s = __fadd_rn(__fmul_rn(st[e], scale),
                                      __ldg(bcol + static_cast<int64_t>(i) * n + ja));
            pa = __fdiv_rn(expf(s - m), l);
          }
          if (vi && kb) {
            const float s = __fadd_rn(__fmul_rn(st[2 + e], scale),
                                      __ldg(bcol + static_cast<int64_t>(i) * n + jb));
            pb = __fdiv_rn(expf(s - m), l);
          }
          p[half][e] = pa;
          p[half][2 + e] = pb;
          ds[half][e] = __fmul_rn(pa, __fsub_rn(dp[e], dl));
          ds[half][2 + e] = __fmul_rn(pb, __fsub_rn(dp[2 + e], dl));
        }
      }
      // A[key][query] for 16 queries: dv += p^T do, dk += ds^T q
      const uint32_t pf[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      const uint32_t sf[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      const __nv_bfloat16* dr = dot + g * kStride + kk * 16 + t * 2;
      const __nv_bfloat16* qr = qt + g * kStride + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(accv[dn], pf, ld32(dr + dn * 8 * kStride), ld32(dr + dn * 8 * kStride + 8));
        mma_bf16(acck[dn], sf, ld32(qr + dn * 8 * kStride), ld32(qr + dn * 8 * kStride + 8));
      }
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

// ---------------------------------------------------------------------------
// 2. scalar path: f32 or bf16, head dim <= 128
// ---------------------------------------------------------------------------

constexpr int kMaxScalarD = 128;
constexpr int kChunk = 16;   // query rows (rows kernel) or keys (cols kernel) per block

// per warp: the rows of q and do, then s/p and dp/bf16(ds) over all n keys
size_t scalar_smem_bytes(int n, int d) {
  return static_cast<size_t>(kWarps) * (2 * d + 2 * static_cast<size_t>(n)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_long_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ bias,
                               const T* __restrict__ dout, T* __restrict__ dq,
                               float* __restrict__ ds_ws, T* __restrict__ pc_ws,
                               int n, int heads, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bi = blockIdx.x;
  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, d);
  const int64_t base = layout_base(bi, h, n, heads, d, c);
  const int64_t wbase = (static_cast<int64_t>(bi) * heads + h) * n * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xw = reinterpret_cast<float*>(smem) + static_cast<size_t>(warp) * (2 * d + 2 * n);
  float* yw = xw + d;   // the row of do (xw: the row of q)
  float* pw = yw + d;   // s, then p
  float* sw = pw + n;   // dp, then bf16(ds)

  const int row_end = min(n, (static_cast<int>(blockIdx.z) + 1) * kChunk);
  for (int i = blockIdx.z * kChunk + warp; i < row_end; i += kWarps) {
    const int64_t row = base + static_cast<int64_t>(i) * c;
    for (int e = lane; e < d; e += 32) {
      xw[e] = to_f32(q[row + e]);
      yw[e] = to_f32(dout[row + e]);
    }
    __syncwarp();
    const float* brow = bias + (static_cast<int64_t>(h) * n + i) * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const T* kr = k + base + static_cast<int64_t>(j) * c;
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
      const T* vr = v + base + static_cast<int64_t>(j) * c;
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
      for (int j = 0; j < n; ++j) {
        acc = fmaf(sw[j], to_f32(k[base + static_cast<int64_t>(j) * c + e]), acc);
      }
      dq[row + e] = from_f32<T>(__fmul_rn(acc, scale));
    }
    __syncwarp();   // xw / yw / pw / sw are rewritten by the warp's next row
  }
}

// ds_ws and pc_ws were written by the rows kernel, launched before this one
// on the same stream
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_long_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                               const float* __restrict__ ds_ws, const T* __restrict__ pc_ws,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int n, int heads, int d, float scale) {
  const int bi = blockIdx.x;
  const int h = blockIdx.y;
  const int c = layout_row_stride(heads, d);
  const int64_t base = layout_base(bi, h, n, heads, d, c);
  const int64_t wbase = (static_cast<int64_t>(bi) * heads + h) * n * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key_end = min(n, (static_cast<int>(blockIdx.z) + 1) * kChunk);
  for (int j = blockIdx.z * kChunk + warp; j < key_end; j += kWarps) {
    const int64_t row = base + static_cast<int64_t>(j) * c;
    for (int e = lane; e < d; e += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < n; ++i) {
        const int64_t w = wbase + static_cast<int64_t>(i) * n + j;
        const int64_t x = base + static_cast<int64_t>(i) * c + e;
        ak = fmaf(to_f32(from_f32<T>(ds_ws[w])), to_f32(q[x]), ak);
        av = fmaf(to_f32(pc_ws[w]), to_f32(dout[x]), av);
      }
      dk[row + e] = from_f32<T>(__fmul_rn(ak, scale));
      dv[row + e] = from_f32<T>(av);
    }
  }
}

template <typename T>
int launch_scalar(const void* q, const void* k, const void* v, const float* bias,
                  const void* dout, void* dq, void* dk, void* dv, float* ds_ws, void* pc_ws,
                  int b, int n, int heads, int d, float scale, cudaStream_t stream) {
  const size_t smem = scalar_smem_bytes(n, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_long_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b, heads, (n + kChunk - 1) / kChunk);
  attention_long_bwd_rows_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), static_cast<T*>(dq), ds_ws, static_cast<T*>(pc_ws),
      n, heads, d, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_long_bwd_cols_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout), ds_ws,
      static_cast<const T*>(pc_ws), static_cast<T*>(dk), static_cast<T*>(dv),
      n, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 3. db = sum over the batch of the per-sample ds, in batch order
// ---------------------------------------------------------------------------

__global__ void attention_long_bwd_bias_sum_kernel(const float* __restrict__ ds_ws,
                                                   float* __restrict__ db, int64_t hnn,
                                                   int b) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < hnn;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int bi = 0; bi < b; ++bi) s += ds_ws[bi * hnn + i];
    db[i] = s;
  }
}

bool use_mma(const void* const* ptrs, int count, int d, int is_bf16) {
  uintptr_t all = 0;
  for (int i = 0; i < count; ++i) all |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return is_bf16 && d == kMmaD && all % 16 == 0;
}

// q, k, v, dout, dq, dk, dv in the translation unit's layout, one dtype (bf16
// or f32); bias, db: (heads, n, n) f32; ds_ws: (b, heads, n, n) f32 scratch.
// The tensor-core path also takes stats: (3, b, heads, n) f32 scratch (pc_ws
// unused); the scalar path pc_ws: (b, heads, n, n) scratch in the operands'
// dtype (stats unused).
int dispatch_long_bwd(const void* q, const void* k, const void* v, const float* bias,
                      const void* dout, void* dq, void* dk, void* dv, float* db, float* ds_ws,
                      void* pc_ws, float* stats, int b, int n, int heads, int d, float scale,
                      int is_bf16, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int chunks = (n + kChunk - 1) / kChunk;   // the finer of the two grids' z
  if (heads > 65535 || chunks > 65535 || d < 1 || d > kMaxScalarD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  int rc;
  if (use_mma(ptrs, 7, d, is_bf16)) {
    if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(b, heads, (n + kTile - 1) / kTile);
    attention_long_bwd_rows_mma_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(dq), ds_ws, stats, n, heads, scale);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    attention_long_bwd_cols_mma_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, static_cast<const __nv_bfloat16*>(dout),
        stats, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        n, heads, scale);
    rc = static_cast<int>(cudaGetLastError());
  } else {
    if (pc_ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    rc = is_bf16 ? launch_scalar<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws,
                                                b, n, heads, d, scale, stream)
                 : launch_scalar<float>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n,
                                        heads, d, scale, stream);
  }
  if (rc != 0) return rc;
  const int64_t hnn = static_cast<int64_t>(heads) * n * n;
  const int64_t blocks = (hnn + 255) / 256;
  attention_long_bwd_bias_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                                       stream>>>(ds_ws, db, hnn, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
