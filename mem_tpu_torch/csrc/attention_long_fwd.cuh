// K3f: per-head softmax(q k^T * scale + bias_h) v on flat layouts at long N,
// and the same kernels on head-major (B, H, N, D) layouts (K5b): the
// translation unit that includes this file picks the addressing
// (MEM_ATTENTION_HEAD_MAJOR -> kHeadMajor, layout_row_stride / layout_base
// and the tensor maps below); the entry points are in attention_long_fwd.cu
// and attention_long_fwd_bhnd.cu. A per-file constant rather than a template
// argument, as in attention_fwd.cuh: the flat translation unit then compiles
// exactly as if the head-major one did not exist.
//
// Replaces mem_tpu/ops/attention.py:_fwd_flat_long_kernel
// (fused_attention_flat_long), the attention of the segmentation backbone:
// q, k, v (B, 1025, 12*64) bf16, bias (12, 1025, 1025) f32 shared by the
// batch, scale = 1/8. The TPU kernel keeps one sample's flat tiles, the whole
// bias and a full (N, N) f32 score tile per head in VMEM. No Hopper block can
// (64 query rows x 1025 keys in f32 are 262 KB), so the keys go by in tiles
// of 64.
//
// What bounds it on the H100: at B = 8 the function moves q, k, v, o (50 MB)
// plus the bias (50 MB) for 25.8 GFLOP, so device memory bounds it (about
// 0.03 ms). Behind that, L2: every block reads its (head, query rows) strip
// of the bias and its head's K and V from L2. With one block per (sample,
// head, 128 query rows) that is 403 MB of bias and 241 MB of K and V at
// B = 8, ~0.1 ms at 6-7 TB/s. A block on two samples of one (head, query
// tile) would halve the bias and double K and V: the same sum, and twice the
// registers. So the grid is (sample, head, query tile), the sample fastest:
// the B blocks that read one bias strip run together, and the strip comes
// from device memory once and from L2 after. Two kernels:
//
// 1. attention_long_fwd_wgmma_kernel -- bf16, head dim 64 (the seg
//    backbone) or 32. One pass with an online softmax, per key tile:
//      s = (q.k) * scale + bias, rounded twice as the reference (__fmul_rn,
//          __fadd_rn); keys >= N masked to -inf;
//      the running row max m grows; the row sum l and the output o are
//          rescaled by exp(m_old - m_new);
//      p~ = exp(s - m), summed into l in f32, rounded to bf16 as the A
//          operand of o += p~ v;
//    and at the end o * (1 / l), rounded to bf16 once. The reference rounds
//    the normalised p to bf16 where this rounds the unnormalised p~: the
//    result differs from the plain version by that rounding and by summation
//    order (tests/test_torch_attention_long.py emulates this order against
//    the Pallas kernel). exp is ex2.approx with log2(e) folded in.
//    Block: two consumer warpgroups of 64 query rows and one producer warp.
//    Both products are wgmma m64n64k16 with f32 accumulators: s = q k^T with
//    the warpgroup's Q tile and the K tile from shared memory (K-major, 128 B
//    swizzle); o += p~ v with p~ taken from the score registers as the A
//    operand and the V tile as an MN-major B operand (the descriptor's
//    transpose bit reads it as it lies, d contiguous: nothing is transposed
//    by hand). The producer keeps a ring of three K / V stages in flight
//    (TMA: 3-D tensor maps with 128 B swizzle; rows past N come back as
//    zeros), on a full and an empty mbarrier per stage. Each consumer issues
//    tile j's q k^T together with tile j - 1's p~ v and runs tile j's softmax
//    while the second product is still on the tensor cores.
//    The bias cannot go through TMA (a row of 1025 f32 is 4100 bytes; TMA
//    wants 16-byte strides). Each thread loads its two rows' 16 keys of the
//    tile straight into the accumulator's layout, one tile ahead of their
//    use. (A shared-memory ring fed by one bulk copy per row's 16-byte-aligned
//    span, issued by the producer, was tried first: it was right, but its 128
//    small copies per tile queue in the copy engine, and the kernel ran
//    slower than with these register loads.)
//    Head dim 32 (the MAE decoder's 16 heads of 512, where K2f launches it
//    for mem_tpu/ops/attention.py:_fwd_flat_kernel through _fa_flat_fwd) is
//    the template's D = 32 instantiation of the same body, with the same
//    arithmetic in the same order: 64-byte rows, TMA and the descriptors on
//    64 B swizzle (8-row groups 512 B apart), 4 KB tiles; s = q k^T two
//    m64n64k16 steps, o += p~ v a chain of four m64n32k16 steps (16
//    accumulator floats a thread where D = 64 keeps 32). At (128, 197,
//    16 x 32) the function moves 105.8 MB for 10.2 GFLOP (0.032 ms); what
//    holds the kernel is each block's dependent chain over its four key
//    tiles (scores, softmax, p~ v) and the bias loads. The ring depth
//    (hopper.cuh's kRingStages, the backward's too) and the block's query
//    rows were measured once, with the library built at each choice (device
//    ms at that shape on one H100 80GB HBM3 at 700 W): 2 / 3 / 4 stages
//    0.229 / 0.224 / 0.226 with two consumer warpgroups, 4 stages with one
//    (64 query rows a block) 0.224; the backward 0.850 / 0.880 / 0.876. So
//    2 stages (the lowest sum of both directions) and two consumers (a
//    (b, h)'s K and V read by two blocks, not four).
// 2. attention_long_fwd_kernel -- f32 operands (nothing is rounded to TF32)
//    and the other head dims up to 128: scalar FMAs, one block per (sample, head,
//    32 query rows), K/V tiles staged as f32 with rows padded by one word;
//    each warp owns 8 rows and each lane two keys of the tile. It goes over
//    the keys twice (row max and sum, then p = exp(s - m) / l rounded to the
//    operands' dtype and p v), the reference's order of roundings.
//
// Both mask keys >= N (1025 is not a multiple of 64) and rows >= N, allocate
// nothing and synchronise nothing outside the block.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
// 1. wgmma path: bf16, D = 64 and D = 32
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                       // query rows per consumer warpgroup

// The block at head dim D: kConsumers warpgroups of 64 query rows and one
// producer warp, a ring of kStages K / V stages (a K and a V tile each).
// D = 64: 3 stages of 16 KB, 2 consumers. D = 32: 2 stages of 8 KB, 2
// consumers (measured; see the note on D = 32 above).
template <int D>
struct FwdCfg {
  static constexpr int kConsumers = 2;
  static constexpr int kStages = kRingStages<D>;
  static constexpr int kBlockRows = kWgRows * kConsumers;   // query rows per block
  static constexpr int kThreads = 128 * kConsumers + 32;    // + one producer warp
  static constexpr int kStageBytes = 2 * kTileBytes<D>;
  static constexpr int kQBytes = kConsumers * kTileBytes<D>;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // full[kStages], empty[kStages], q; the 1024 B in front align the swizzled tiles
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

// s = q k^T over one key tile: D / 16 k16 steps along d, 32 bytes apart in
// the swizzled rows; one commit group
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t qtile, uint32_t ktile) {
  wgmma_abt<D>(sc, qtile, ktile);
  wgmma_commit();
}

// o += p~ v over one key tile: the V tile's k16 steps are 16 rows of 2D bytes
// apart; one commit group
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[4][4],
                                         uint32_t vtile) {
  wgmma_ab_mn<D>(o, pf, vtile);
  wgmma_commit();
}

// One key tile of the online softmax: scores s = (q.k) * scale + bias (keys
// >= n at -inf) -> p~ = exp(s - m) in place, m grown to the tile's row max,
// l = l * alpha + sum(p~) (per-thread partials: a row's four lanes share m);
// returns alpha = exp(m_old - m_new) of rows a and b.
__device__ __forceinline__ void online_softmax(float (&sc)[32], const float (&bv)[32], int j0,
                                               int n, int t, float scale, float& ma, float& mb,
                                               float& la, float& lb, float& alpha_a,
                                               float& alpha_b) {
  if (j0 + kTileKeys <= n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = __fadd_rn(__fmul_rn(sc[i], scale), bv[i]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j0 + 8 * j + 2 * t + e < n;
        sc[4 * j + e] = ok ? __fadd_rn(__fmul_rn(sc[4 * j + e], scale), bv[4 * j + e]) : -INFINITY;
        sc[4 * j + 2 + e] =
            ok ? __fadd_rn(__fmul_rn(sc[4 * j + 2 + e], scale), bv[4 * j + 2 + e]) : -INFINITY;
      }
    }
  }
  float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ta = fmaxf(ta, fmaxf(sc[4 * j], sc[4 * j + 1]));
    tb = fmaxf(tb, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float na = fmaxf(ma, quad_max(ta)), nb = fmaxf(mb, quad_max(tb));
  alpha_a = ex2((ma - na) * kLog2e);   // 0 at the first tile (m = -inf)
  alpha_b = ex2((mb - nb) * kLog2e);
  ma = na;
  mb = nb;
  const float ca = na * kLog2e, cb = nb * kLog2e;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], kLog2e, -ca));
      sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], kLog2e, -cb));
      sa += sc[4 * j + e];
      sb += sc[4 * j + 2 + e];
    }
  }
  la = la * alpha_a + sa;
  lb = lb * alpha_b + sb;
}

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, 1)
attention_long_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const float* __restrict__ bias,
                                __nv_bfloat16* __restrict__ out,
                                int n, int heads, float scale) {
  using C = FwdCfg<D>;
  constexpr int kConsumers = C::kConsumers, kStages = C::kStages, kTile = kTileBytes<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~uint32_t{1023};
  const uint32_t full0 = sbase + C::kBarOffset, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;

  const unsigned b = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * C::kBlockRows;
  const int rows = min(C::kBlockRows, n - q0);               // valid rows of the block
  const int active = (rows + kWgRows - 1) / kWgRows;         // warpgroups with a valid row
  const int tiles = (n + kTileKeys - 1) / kTileKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * active);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer warp: one lane loads the Q tiles, then keeps the K / V ring full
    if (threadIdx.x % 32 != 0) return;
    // tensor-map coordinates: (column, row, sample) or (0, row, sample * heads + head)
    const int tc = kHeadMajor ? 0 : h * D;
    const int tb = kHeadMajor ? static_cast<int>(b) * heads + h : static_cast<int>(b);
    mbar_expect_tx(qbar, active * kTile);
    for (int w = 0; w < active; ++w) {
      tma_load(sbase + w * kTile, &tq, qbar, tc, q0 + w * kWgRows, tb);
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int s = tile % kStages, round = tile / kStages;
      if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
      const uint32_t stage = sbase + C::kQBytes + s * C::kStageBytes;
      mbar_expect_tx(full0 + 8 * s, 2 * kTile);
      tma_load(stage, &tk, full0 + 8 * s, tc, tile * kTileKeys, tb);
      tma_load(stage + kTile, &tv, full0 + 8 * s, tc, tile * kTileKeys, tb);
    }
    return;
  }
  if (wg >= active) return;

  const int lane = threadIdx.x % 32, t = lane % 4;
  const int wrow = wg * kWgRows + (threadIdx.x / 32) % 4 * 16 + lane / 4;  // row a in the block
  const int ra = q0 + wrow, rb = ra + 8;
  // rows >= n read the warpgroup's first row of the bias (valid) and are not written
  const float* bias_h = bias + static_cast<int64_t>(h) * n * n;
  const float* ga = bias_h + static_cast<int64_t>(ra < n ? ra : q0 + wg * kWgRows) * n;
  const float* gb = bias_h + static_cast<int64_t>(rb < n ? rb : q0 + wg * kWgRows) * n;
  const uint32_t qtile = sbase + wg * kTile;
  auto ktile = [&](int tile) { return sbase + C::kQBytes + (tile % kStages) * C::kStageBytes; };

  // o: the n64 (D = 64) or n32 (D = 32) accumulator of o += p~ v
  float o[D / 2], sc[32], bc[32], bn[32];
  uint32_t pf[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  // running row max and per-thread partial row sums of rows a and b; key 0
  // is valid, so the max is finite from tile 0 on
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, alpha_a, alpha_b;
  // the bias goes by registers, one tile ahead of its use: bc holds the
  // current tile's, bn the next one's
  load_bias(bc, ga, gb, 0, n, t);
  if (tiles > 1) load_bias(bn, ga, gb, kTileKeys, n, t);
  // tile 0's scores first; then per tile j, s of tile j and o += p~ v of tile
  // j - 1 go to the tensor cores together, and the softmax of tile j runs
  // while the second product is still in flight
  mbar_wait(qbar, 0);
  mbar_wait(full0, 0);
  wgmma_fence();
  issue_qk<D>(sc, qtile, ktile(0));
  wgmma_wait<0>();
  fence_regs(sc);
  online_softmax(sc, bc, 0, n, t, scale, ma, mb, la, lb, alpha_a, alpha_b);
  pack_frags(pf, sc);
  for (int tile = 1; tile < tiles; ++tile) {
    // (two buffers whose roles swap, in a loop unrolled by two, spill at
    // the 168 registers ptxas gives this block; the copy does not)
#pragma unroll
    for (int i = 0; i < 32; ++i) bc[i] = bn[i];
    if (tile + 1 < tiles) load_bias(bn, ga, gb, (tile + 1) * kTileKeys, n, t);
    mbar_wait(full0 + 8 * (tile % kStages), (tile / kStages) & 1);
    wgmma_fence();
    issue_qk<D>(sc, qtile, ktile(tile));
    issue_pv<D>(o, pf, ktile(tile - 1) + kTile);
    wgmma_wait<1>();   // s of this tile is in; the product of the last may still run
    fence_regs(sc);
    online_softmax(sc, bc, tile * kTileKeys, n, t, scale, ma, mb, la, lb, alpha_a, alpha_b);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((tile - 1) % kStages));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
    pack_frags(pf, sc);
  }
  wgmma_fence();
  issue_pv<D>(o, pf, ktile(tiles - 1) + kTile);
  wgmma_wait<0>();
  fence_regs(o);

  const float ia = 1.f / quad_sum(la), ib = 1.f / quad_sum(lb);
  const int c = layout_row_stride(heads, D);
  const int64_t base = layout_base(b, h, n, heads, D, c);
  __nv_bfloat16* oa = out + base + static_cast<int64_t>(ra) * c + 2 * t;
  __nv_bfloat16* ob = out + base + static_cast<int64_t>(rb) * c + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (ra < n) *reinterpret_cast<uint32_t*>(oa + 8 * j) = pack_bf16(o[4 * j] * ia, o[4 * j + 1] * ia);
    if (rb < n) {
      *reinterpret_cast<uint32_t*>(ob + 8 * j) = pack_bf16(o[4 * j + 2] * ib, o[4 * j + 3] * ib);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const float* bias, void* out,
                 int b, int n, int heads, float scale, cudaStream_t stream) {
  using C = FwdCfg<D>;
  const int zs = (n + C::kBlockRows - 1) / C::kBlockRows;
  if (zs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  CUtensorMap tq, tk, tv;
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tq, q, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tk, k, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tv, v, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(attention_long_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b, heads, zs);
  attention_long_fwd_wgmma_kernel<D><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, bias, static_cast<__nv_bfloat16*>(out), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
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


// The wgmma kernel's rule: bf16 at head dim 64 or 32 with all four operands
// 16-byte aligned (TMA's rule for a global address; every row stride is a
// multiple of 64 bytes then).
bool use_mma(const void* q, const void* k, const void* v, const void* out,
             int d, int is_bf16) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  return is_bf16 && wgmma_head_dim(d) && ptrs % 16 == 0;
}

// q, k, v, out in the translation unit's layout, one dtype (bf16 or f32);
// bias: (heads, n, n) f32.
int dispatch_long_fwd(const void* q, const void* k, const void* v, const float* bias,
                      void* out, int b, int n, int heads, int d, float scale, int is_bf16,
                      cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (heads > 65535 || d < 1 || d > kMaxScalarD) return static_cast<int>(cudaErrorInvalidValue);
  if (use_mma(q, k, v, out, d, is_bf16)) {
    return d == 64 ? launch_wgmma<64>(q, k, v, bias, out, b, n, heads, scale, stream)
                   : launch_wgmma<32>(q, k, v, bias, out, b, n, heads, scale, stream);
  }
  if ((n + kRowsPerBlock - 1) / kRowsPerBlock > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return is_bf16 ? launch_scalar_d<__nv_bfloat16>(q, k, v, bias, out, b, n, heads, d, scale,
                                                   stream)
                 : launch_scalar_d<float>(q, k, v, bias, out, b, n, heads, d, scale, stream);
}

}  // namespace
