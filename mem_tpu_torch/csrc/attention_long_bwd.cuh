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
// query rows, db over the batch. The wgmma path (bf16, head dim 64 or 32) keeps
// each in one thread's registers, with no float atomics, by going over the
// scores from both sides and recomputing them from row statistics instead of
// storing p. Both kernels are blocks of two consumer warpgroups of 64 rows
// and one producer warpgroup (setmaxnreg: 24 registers a thread there, 240 in
// the consumers) whose first thread feeds a ring of three stages by TMA (3-D
// tensor maps with 128 B swizzle, zeros past N, the same maps in both layouts as
// K3f's), the sample fastest in the grid so that the blocks reading one bias
// strip run together:
//
// 1. attention_long_bwd_rows_wgmma_kernel, one block per (sample, head, 128
//    query rows). Q and dO tiles are loaded once; the K / V tiles go by twice:
//      pass A: s = q k^T and dp = do v^T (wgmma m64n64k16, K and V K-major);
//              the running row max m, the row sum l of exp(s - m) and
//              t = sum exp(s - m) dp, both rescaled when m grows;
//              delta = t / l;
//      pass B: s and dp again, p = exp(s - m) / l, ds = p (dp - delta) in
//              f32 to a (B, H, N, N') workspace, its rows padded to N' = a
//              multiple of 8 floats, each tile through a swizzled staging
//              buffer in shared memory and a TMA store (scalar stores of
//              the accumulators at a 4100-byte row stride write parts of
//              32-byte sectors and were the kernel's largest cost); and
//              bf16(ds) straight from the accumulators as the register A
//              operand of dq += ds k, the K tile read MN-major through the
//              descriptor's transpose bit (as K3f reads V). Each tile's s and
//              dp are issued behind the last tile's dq product.
//    m, 1 / l and delta go to a (B, H, ceil(N / 64), 3, 64) f32 statistics
//    array, one 768-byte record per 64-row query tile. The template's kPair
//    instantiation is X3's rows kernel (attention_bwd_pair.cu): s and dp as
//    one m64n128k16 chain against a block-diagonal operand (score_products).
// 2. attention_long_bwd_cols_wgmma_kernel, one block per (sample, head, 128
//    keys). Each consumer's K and V tiles stay in shared memory as K-major A
//    operands; the ring brings each query tile's Q and dO (TMA) and its
//    statistics record (one bulk copy). The same Q / dO tile serves K-major
//    for s^T = k q^T and dp^T = v do^T, and MN-major for dv += bf16(p^T) do
//    and dk += bf16(ds^T) q. p^T and ds^T are rebuilt from the statistics
//    and the transposed bias (register loads into the accumulator layout,
//    issued while s^T and dp^T are on the tensor cores). Four 64 x 64 f32
//    accumulators are live (s^T, dp^T, dk, dv); the bias and the A fragments
//    are never live at once.
// 3. attention_long_bwd_bias_sum_kernel adds the workspace's per-sample ds in
//    batch order (b = 0, 1, ...), the TPU kernel's own order: db is
//    bit-reproducible from run to run.
// In both kernels the bias comes by register loads into the accumulator
// layout: its 4100-byte rows are no TMA stride. exp is ex2.approx of
// (s - m) * log2(e); p is exp(s - m) times 1 / l. The price of this shape:
// nine products instead of five, and the f32 ds workspace (0.81 GB at B = 16,
// written once and read once: 1.6 GB of traffic, about 0.5 ms). Summing db
// inside the cols kernel without the workspace would read and write each
// block's (N x 64) f32 strip of db once per sample, (2B - 1) H N^2 4 bytes in
// all (1.6 GB at B = 16), as much as the workspace's round trip, and L2 (50
// MB) does not hold the ~100 MB the resident blocks would need.
//
// Head dim 32 (the MAE decoder's 16 heads of 512, where K2b launches these
// kernels for mem_tpu/ops/attention.py:_bwd_flat_kernel through _fa_flat_bwd)
// is the template's D = 32 instantiation of the three kernels, with D = 64's
// order of arithmetic: 64-byte rows on 64 B swizzle, 4 KB tiles; s, dp and
// s^T, dp^T two m64n64k16 steps each, dq += ds k, dv += p^T do and dk += ds^T
// q chains of four m64n32k16 steps (16 accumulator floats a thread). The
// products halve; what they leave is per (b, h) the bias loads (twice in the
// rows kernel, once in the columns kernel), the exps, and the padded ds
// workspace: at (128, 197, 16 x 32) 322.8 MB written by the rows kernel and
// read by the bias sum (about 0.19 ms at 3.35 TB/s where L2 does not keep
// it), against a bound of 0.055 ms for the function. Ring depth: 2 stages
// (measured with attention_long_fwd.cuh's forward: the note there).
//
// The scalar path (f32 operands, where tensor cores would round to TF32, and
// head dims other than 64 and 32, up to 128) is K2b's scalar kernel cut in two:
// attention_long_bwd_rows_kernel (one query row per warp at a time, the
// row's s, p, dp in shared memory, ds and p rounded to the operand dtype to
// (B, H, N, N) workspaces) and attention_long_bwd_cols_kernel (one key per
// warp at a time, dk and dv from the workspaces), reading K, V, Q and dO from
// device memory through the caches.
//
// No kernel allocates or synchronises: the wrapper allocates the outputs, the
// workspaces and the statistics.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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
// are (B, H, N, N), (B, H, ceil(N / 64), 3, 64) and (H, N, N) in both.
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
// 1. wgmma path: bf16, D = 64 and D = 32
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                       // rows (queries or keys) per consumer warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups per block
constexpr int kBlockRows = kWgRows * kConsumers;  // rows per block
// ring depth, both kernels: hopper.cuh's kRingStages (at the MAE decoder's
// N = 197, 4 stages would hold a (b, h)'s four key tiles at once, and K2b
// took 3 % longer with them)
template <int D>
constexpr int kStages = kRingStages<D>;
constexpr int kWgThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
// setmaxnreg: the block starts at 168 registers a thread (384 threads); the
// producer warpgroup, one thread of which issues the copies, keeps 24 and the
// consumers take 240 (2 x 128 x 240 + 128 x 24 = 64,512 = 384 x 168)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
template <int D>
constexpr int kPairBytes = kConsumers * kTileBytes<D>;    // one tile per consumer
// (B*H, ceil(N / 64), 3, 64) f32: per 64-row query tile its m, 1 / l and delta
constexpr int kStatFloats = 3 * kWgTile;
constexpr int kStatBytes = kStatFloats * 4;
// The ds workspace's rows are padded to a multiple of 8 floats (32 B), so
// that its row stride suits TMA and every 8-float group is one sector; a ds
// tile leaves by TMA store from a staging buffer of two 64 x 32 f32 halves
// (128 B swizzle), one per consumer and tile parity.
constexpr int kWsAlign = 8;
constexpr int kDsHalfBytes = kWgTile * 32 * 4;
constexpr int kDsTileBytes = 2 * kDsHalfBytes;
// rows kernel: Q and dO of each consumer, the ring of K / V stages, the ds
// staging buffers. A stage is K | V, or with kPair (X3) K | Z | V, Z a zero
// tile: the block-diagonal operand [[k^T, 0], [0, v^T]] as the B operand of
// one m64n128k16 chain (K | Z for its first four k16 steps, Z | V for the
// last four; a descriptor strides 1024 B per 8 rows, so each pair of tiles
// lies contiguous)
template <int D, bool kPair>
constexpr int kRowsStageBytes = (kPair ? 3 : 2) * kTileBytes<D>;
template <int D, bool kPair>
constexpr int kRowsDsOffset = 2 * kPairBytes<D> + kStages<D> * kRowsStageBytes<D, kPair>;
template <int D, bool kPair>
constexpr int kRowsBarOffset = kRowsDsOffset<D, kPair> + 2 * kConsumers * kDsTileBytes;
// cols kernel: K and V of each consumer, then the ring of Q / dO / stats
// stages (each 1024-aligned for the swizzled tiles)
template <int D>
constexpr int kColsStageBytes = 2 * kTileBytes<D> + 1024;
template <int D>
constexpr int kColsBarOffset = 2 * kPairBytes<D> + kStages<D> * kColsStageBytes<D>;
// full[kStages], empty[kStages], one more; the 1024 B in front align the
// tiles. D = 64: rows kernel 148,536 B (X3's 173,112), cols kernel 86,072 B;
// D = 32 at 2 stages: 99,368 B and 35,880 B.
template <int D, bool kPair>
constexpr int kRowsSmemBytes = 1024 + kRowsBarOffset<D, kPair> + 8 * (2 * kStages<D> + 1);
template <int D>
constexpr int kColsSmemBytes = 1024 + kColsBarOffset<D> + 8 * (2 * kStages<D> + 1);
static_assert(kStatBytes <= 1024, "a stage's stats fit its 1024 B");

// Scores of one tile in place: (acc * scale) + bias with the reference's two
// roundings; entries whose key (rows kernel) or query (cols kernel) is >= n
// at -inf when the tile is ragged. ``j0`` is the tile's first column.
__device__ __forceinline__ void tile_scores(float (&sc)[32], const float (&bv)[32], int j0, int n,
                                            int t, float scale) {
  if (j0 + kWgTile <= n) {
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
}

__device__ __forceinline__ float expm(float s, float m) { return ex2(__fmul_rn(s - m, kLog2e)); }

// The rows kernel's two score products of a key tile, issued (not
// committed): s = q k^T and dp = do v^T from the ring stage at ``stage``.
// K3b: two m64n64k16 chains of four steps on a stage K | V. X3 (kPair): the
// reference's pair [s | dp] = [q | do] . [[k^T, 0], [0, v^T]] as one
// m64n128k16 chain of eight on a stage K | Z | V, zero blocks included: steps
// 0-3 read the Q tile against K | Z, steps 4-7 the dO tile against Z | V.
// s's sum adds do . 0 after q k^T and dp's starts with q . 0: exact zeros
// added to K3b's f32 sums in K3b's step order, so the results are its bits.
template <int D, bool kPair>
__device__ __forceinline__ void score_products(float (&sc)[32], float (&dp)[32], uint32_t qtile,
                                               uint32_t dotile, uint32_t stage) {
  if constexpr (kPair) {
    static_assert(D == 64, "X3's pair is K2b's D = 64 body");
    wgmma_ss_n128_fresh(sc, dp, sw128_desc(qtile), sw128_desc(stage));
#pragma unroll
    for (int kk = 1; kk < 2 * D / 16; ++kk) {
      const uint32_t a = (kk < 4 ? qtile : dotile) + 32 * (kk % 4);
      const uint32_t b = stage + (kk < 4 ? 0 : kTileBytes<D>) + 32 * (kk % 4);
      wgmma_ss_n128(sc, dp, sw128_desc(a), sw128_desc(b));
    }
  } else {
    wgmma_abt_fresh<D>(sc, qtile, stage);
    wgmma_abt_fresh<D>(dp, dotile, stage + kTileBytes<D>);
  }
}

// rows kernel: the producer loads each consumer's Q and dO tiles once, then
// the key tiles twice (pass A, then pass B) through the ring. tws: the ds
// workspace (n, n, B*H) f32, rows ws_stride(n) floats apart, boxes of 64 rows
// of 32 floats. stats: (B*H, ceil(n / 64), 3, 64) f32 = m, 1 / l, delta of each
// query row (0 past n). kPair: X3's products (score_products); K3b's otherwise.
// Built with -DMEM_ATTN_PLANT_FAULT (chip_smoke.py's fault check, a library
// of its own), the D = 32 instantiation skips dq's last k16 step of every key
// tile.
template <int D, bool kPair>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_long_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const __grid_constant__ CUtensorMap tws,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                                     int n, int heads, float scale) {
  constexpr int kS = kStages<D>, kTile = kTileBytes<D>, kPairB = kPairBytes<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~uint32_t{1023};
  const uint32_t full0 = sbase + kRowsBarOffset<D, kPair>, empty0 = full0 + 8 * kS;
  const uint32_t qbar = empty0 + 8 * kS;
  constexpr int kStage = kRowsStageBytes<D, kPair>;

  const unsigned b = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * kBlockRows;
  const int rows = min(kBlockRows, n - q0);                  // valid rows of the block
  const int active = (rows + kWgRows - 1) / kWgRows;         // warpgroups with a valid row
  const int tiles = (n + kWgTile - 1) / kWgTile;
  const int wg = threadIdx.x / 128;

  if constexpr (kPair) {
    // every stage's zero tile, written once: TMA never writes it
    unsigned char* ring = smem_raw + (sbase - smem_u32(smem_raw)) + 2 * kPairB;
    for (int i = threadIdx.x; i < kS * kTile / 16; i += kWgThreads) {
      const int s = i / (kTile / 16), off = i % (kTile / 16) * 16;
      *reinterpret_cast<uint4*>(ring + s * kStage + kTile + off) = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();   // before the first product reads them
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * active);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    // tensor-map coordinates: (column, row, sample) or (0, row, sample * heads + head)
    const int tc = kHeadMajor ? 0 : h * D;
    const int tb = kHeadMajor ? static_cast<int>(b) * heads + h : static_cast<int>(b);
    mbar_expect_tx(qbar, 2 * active * kTile);
    for (int w = 0; w < active; ++w) {
      tma_load(sbase + w * kTile, &tq, qbar, tc, q0 + w * kWgRows, tb);
      tma_load(sbase + kPairB + w * kTile, &tdo, qbar, tc, q0 + w * kWgRows, tb);
    }
    for (int it = 0; it < 2 * tiles; ++it) {
      const int s = it % kS, round = it / kS;
      const int j0 = (it < tiles ? it : it - tiles) * kWgTile;
      if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
      const uint32_t stage = sbase + 2 * kPairB + s * kStage;
      mbar_expect_tx(full0 + 8 * s, 2 * kTile);
      tma_load(stage, &tk, full0 + 8 * s, tc, j0, tb);
      tma_load(stage + kStage - kTile, &tv, full0 + 8 * s, tc, j0, tb);
    }
    return;
  }
  if (wg >= active) return;
  regs_inc<kConsumerRegs>();

  const int lane = threadIdx.x % 32, t = lane % 4, wtid = threadIdx.x % 128;
  const int trow = (threadIdx.x / 32) % 4 * 16 + lane / 4;   // row a in the warpgroup's tile
  const int ra = q0 + wg * kWgRows + trow, rb = ra + 8;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  // rows >= n read the warpgroup's first row of the bias (valid) and write
  // nothing but zero statistics
  const float* bias_h = bias + static_cast<int64_t>(h) * n * n;
  const float* ga = bias_h + static_cast<int64_t>(ra < n ? ra : q0 + wg * kWgRows) * n;
  const float* gb = bias_h + static_cast<int64_t>(rb < n ? rb : q0 + wg * kWgRows) * n;
  const uint32_t qtile = sbase + wg * kTile, dotile = qtile + kPairB;
  auto ktile = [&](int it) { return sbase + 2 * kPairB + (it % kS) * kStage; };

  float sc[32], dp[32], bc[32], bn[32];
  // the bias goes by registers, one tile ahead of its use, over the 2 * tiles
  // tiles of both passes: bc holds the current tile's, bn the next one's
  auto next_bias = [&](int it) {
#pragma unroll
    for (int i = 0; i < 32; ++i) bc[i] = bn[i];
    if (it + 1 < 2 * tiles) load_bias(bn, ga, gb, (it + 1) % tiles * kWgTile, n, t);
  };
  load_bias(bc, ga, gb, 0, n, t);
  load_bias(bn, ga, gb, 1 % tiles * kWgTile, n, t);
  mbar_wait(qbar, 0);

  // pass A: s and dp per key tile; the running row max m, and the per-thread
  // partials of l = sum exp(s - m) and t = sum exp(s - m) dp, both rescaled
  // when m grows. Key 0 is valid, so m is finite from tile 0 on; keys >= n
  // give exp(-inf) = 0 and dp = 0 (K and V come back as zeros past n).
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, ta = 0.f, tb = 0.f;
  for (int it = 0; it < tiles; ++it) {
    if (it > 0) next_bias(it);
    mbar_wait(full0 + 8 * (it % kS), (it / kS) & 1);
    wgmma_fence();
    score_products<D, kPair>(sc, dp, qtile, dotile, ktile(it));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % kS));
    tile_scores(sc, bc, it * kWgTile, n, t, scale);
    float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xa = fmaxf(xa, fmaxf(sc[4 * j], sc[4 * j + 1]));
      xb = fmaxf(xb, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float na = fmaxf(ma, quad_max(xa)), nb = fmaxf(mb, quad_max(xb));
    const float fa = expm(ma, na), fb = expm(mb, nb);   // 0 at the first tile (m = -inf)
    la *= fa;
    ta *= fa;
    lb *= fb;
    tb *= fb;
    ma = na;
    mb = nb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ea = expm(sc[4 * j + e], ma), eb = expm(sc[4 * j + 2 + e], mb);
        la += ea;
        lb += eb;
        ta = fmaf(ea, dp[4 * j + e], ta);
        tb = fmaf(eb, dp[4 * j + 2 + e], tb);
      }
    }
  }
  la = quad_sum(la);
  lb = quad_sum(lb);
  const float dla = __fdiv_rn(quad_sum(ta), la), dlb = __fdiv_rn(quad_sum(tb), lb);
  const float ila = __frcp_rn(la), ilb = __frcp_rn(lb);
  if (t == 0) {
    float* st = stats + (bh * tiles + (q0 / kWgTile + wg)) * kStatFloats + trow;
    st[0] = ra < n ? ma : 0.f;
    st[kWgTile] = ra < n ? ila : 0.f;
    st[2 * kWgTile] = ra < n ? dla : 0.f;
    st[8] = rb < n ? mb : 0.f;
    st[kWgTile + 8] = rb < n ? ilb : 0.f;
    st[2 * kWgTile + 8] = rb < n ? dlb : 0.f;
  }

  // pass B: s and dp again, p = exp(s - m) / l, ds = p (dp - delta) in f32 to
  // the workspace, and bf16(ds) from the accumulators as the A fragments of
  // dq += ds k (the K tile read MN-major). Each tile's s and dp go to the
  // tensor cores behind the last tile's dq product, whose K stage is released
  // once it is done.
  // The 16-byte chunk (of 8) that this thread's float pair of 8-column group
  // j lands in within its row of a swizzled 128-byte half-row; rows a and b
  // share it (row % 8 = lane / 4 for both)
  auto ds_chunk = [&](int j) { return ((2 * (j % 4) + (t >> 1)) ^ (lane / 4)) * 16 + 8 * (t & 1); };
  float acc[D / 2];   // dq's n64 or n32 accumulator, written by the first tile's product
  uint32_t pf[4][4];
  for (int it = tiles; it < 2 * tiles; ++it) {
    const int j0 = (it - tiles) * kWgTile;
    next_bias(it);
    mbar_wait(full0 + 8 * (it % kS), (it / kS) & 1);
    wgmma_fence();
    score_products<D, kPair>(sc, dp, qtile, dotile, ktile(it));
    wgmma_commit();
    if (it > tiles) {
      wgmma_wait<1>();   // the last tile's dq product is done
      fence_frags(pf);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kS));
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    tile_scores(sc, bc, j0, n, t, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = __fmul_rn(expm(sc[4 * j + e], ma), ila);
        const float pb = __fmul_rn(expm(sc[4 * j + 2 + e], mb), ilb);
        sc[4 * j + e] = __fmul_rn(pa, __fsub_rn(dp[4 * j + e], dla));
        sc[4 * j + 2 + e] = __fmul_rn(pb, __fsub_rn(dp[4 * j + 2 + e], dlb));
      }
    }
    pack_frags(pf, sc);
#ifdef MEM_ATTN_PLANT_FAULT
    if constexpr (D == 32 && !kPair) pf[3][0] = pf[3][1] = pf[3][2] = pf[3][3] = 0u;
#endif
    wgmma_fence();
    wgmma_ab_mn<D>(acc, pf, ktile(it), it > tiles);
    wgmma_commit();
    // ds leaves through this warpgroup's staging buffer of the tile's
    // parity, by one thread's TMA store (rows and keys >= n are clipped);
    // the store two tiles back must have read the buffer first
    const uint32_t sbuf =
        sbase + kRowsDsOffset<D, kPair> + (2 * wg + ((it - tiles) & 1)) * kDsTileBytes;
    if (wtid == 0) bulk_wait_read<1>();
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t at = sbuf + (j / 4) * kDsHalfBytes + ds_chunk(j);
      st_shared_f2(at + trow * 128, sc[4 * j], sc[4 * j + 1]);
      st_shared_f2(at + (trow + 8) * 128, sc[4 * j + 2], sc[4 * j + 3]);
    }
    fence_async_smem();
    named_barrier(1 + wg, 128);
    if (wtid == 0) {
      tma_store(&tws, sbuf, j0, q0 + wg * kWgRows, static_cast<int>(bh));
      tma_store(&tws, sbuf + kDsHalfBytes, j0 + 32, q0 + wg * kWgRows, static_cast<int>(bh));
      bulk_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_frags(pf);
  if (wtid == 0) bulk_wait<0>();

  const int c = layout_row_stride(heads, D);
  const int64_t base = layout_base(b, h, n, heads, D, c);
  __nv_bfloat16* oa = dq + base + static_cast<int64_t>(ra) * c + 2 * t;
  __nv_bfloat16* ob = dq + base + static_cast<int64_t>(rb) * c + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (ra < n) {
      *reinterpret_cast<uint32_t*>(oa + 8 * j) =
          pack_bf16(__fmul_rn(acc[4 * j], scale), __fmul_rn(acc[4 * j + 1], scale));
    }
    if (rb < n) {
      *reinterpret_cast<uint32_t*>(ob + 8 * j) =
          pack_bf16(__fmul_rn(acc[4 * j + 2], scale), __fmul_rn(acc[4 * j + 3], scale));
    }
  }
}

// The transposed bias of keys a and b (columns ca, cb of the head's bias) at
// this thread's 16 query rows of the query tile at i0, in the accumulator's
// order; 0 past n.
__device__ __forceinline__ void load_bias_t(float (&bv)[32], const float* ca, const float* cb,
                                            int i0, int n, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + 8 * j + 2 * t + e;
      const int64_t off = static_cast<int64_t>(i) * n;
      bv[4 * j + e] = i < n ? __ldg(ca + off) : 0.f;
      bv[4 * j + 2 + e] = i < n ? __ldg(cb + off) : 0.f;
    }
  }
}

// cols kernel: the producer warp loads each consumer's K and V tiles once,
// then per query tile its Q and dO tiles and its statistics through the
// ring. Keys are the product's rows here: s^T = k q^T, dp^T = v do^T.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_long_bwd_cols_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ stats,
                                     __nv_bfloat16* __restrict__ dk,
                                     __nv_bfloat16* __restrict__ dv,
                                     int n, int heads, float scale) {
  constexpr int kS = kStages<D>, kTile = kTileBytes<D>, kPairB = kPairBytes<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~uint32_t{1023};
  const unsigned char* sgen = smem_raw + (sbase - smem_u32(smem_raw));   // sbase, generic
  const uint32_t full0 = sbase + kColsBarOffset<D>, empty0 = full0 + 8 * kS;
  const uint32_t kvbar = empty0 + 8 * kS;

  const unsigned b = blockIdx.x;
  const int h = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;
  const int keys = min(kBlockRows, n - k0);                  // valid keys of the block
  const int active = (keys + kWgRows - 1) / kWgRows;         // warpgroups with a valid key
  const int tiles = (n + kWgTile - 1) / kWgTile;
  const int wg = threadIdx.x / 128;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * active);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    const int tc = kHeadMajor ? 0 : h * D;
    const int tb = kHeadMajor ? static_cast<int>(b) * heads + h : static_cast<int>(b);
    mbar_expect_tx(kvbar, 2 * active * kTile);
    for (int w = 0; w < active; ++w) {
      tma_load(sbase + w * kTile, &tk, kvbar, tc, k0 + w * kWgRows, tb);
      tma_load(sbase + kPairB + w * kTile, &tv, kvbar, tc, k0 + w * kWgRows, tb);
    }
    const float* st = stats + bh * tiles * kStatFloats;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kS, round = it / kS;
      if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
      const uint32_t stage = sbase + 2 * kPairB + s * kColsStageBytes<D>;
      mbar_expect_tx(full0 + 8 * s, 2 * kTile + kStatBytes);
      tma_load(stage, &tq, full0 + 8 * s, tc, it * kWgTile, tb);
      tma_load(stage + kTile, &tdo, full0 + 8 * s, tc, it * kWgTile, tb);
      bulk_load(stage + 2 * kTile, st + it * kStatFloats, kStatBytes, full0 + 8 * s);
    }
    return;
  }
  if (wg >= active) return;
  regs_inc<kConsumerRegs>();

  const int lane = threadIdx.x % 32, t = lane % 4;
  const int ja = k0 + wg * kWgRows + (threadIdx.x / 32) % 4 * 16 + lane / 4, jb = ja + 8;
  // keys >= n read the warpgroup's first key of the bias (valid): their rows
  // of dk and dv are computed on zeros and not written
  const float* bias_h = bias + static_cast<int64_t>(h) * n * n;
  const float* ca = bias_h + (ja < n ? ja : k0 + wg * kWgRows);
  const float* cb = bias_h + (jb < n ? jb : k0 + wg * kWgRows);
  const uint32_t ktile = sbase + wg * kTile, vtile = ktile + kPairB;
  auto qstage = [&](int it) { return 2 * kPairB + (it % kS) * kColsStageBytes<D>; };

  // dv's and dk's n64 or n32 accumulators (written by tile 0)
  float st[32], dpt[32], bc[32], accv[D / 2], acck[D / 2];
  uint32_t pf[4][4], sf[4][4];
  mbar_wait(kvbar, 0);
  for (int it = 0; it < tiles; ++it) {
    const int i0 = it * kWgTile;
    const uint32_t stage = sbase + qstage(it);
    mbar_wait(full0 + 8 * (it % kS), (it / kS) & 1);
    wgmma_fence();
    wgmma_abt_fresh<D>(st, ktile, stage);
    wgmma_abt_fresh<D>(dpt, vtile, stage + kTile);
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();   // the last tile's dv and dk products are done
      fence_frags(pf);
      fence_frags(sf);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kS));
    }
    load_bias_t(bc, ca, cb, i0, n, t);   // while s^T and dp^T are on the tensor cores
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // this tile's m, 1 / l and delta, per query (the accumulator's column)
    const float* sm = reinterpret_cast<const float*>(sgen + qstage(it) + 2 * kTile);
    const bool ragged = i0 + kWgTile > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float m = sm[col], il = sm[kWgTile + col], dl = sm[2 * kWgTile + col];
        const float sa = __fadd_rn(__fmul_rn(st[4 * j + e], scale), bc[4 * j + e]);
        const float sb = __fadd_rn(__fmul_rn(st[4 * j + 2 + e], scale), bc[4 * j + 2 + e]);
        float pa = __fmul_rn(expm(sa, m), il), pb = __fmul_rn(expm(sb, m), il);
        if (ragged && i0 + col >= n) pa = pb = 0.f;   // queries >= n: p = ds = 0
        st[4 * j + e] = pa;
        st[4 * j + 2 + e] = pb;
        dpt[4 * j + e] = __fmul_rn(pa, __fsub_rn(dpt[4 * j + e], dl));
        dpt[4 * j + 2 + e] = __fmul_rn(pb, __fsub_rn(dpt[4 * j + 2 + e], dl));
      }
    }
    pack_frags(pf, st);
    pack_frags(sf, dpt);
    wgmma_fence();
    wgmma_ab_mn<D>(accv, pf, stage + kTile, it > 0);   // dv += p^T do
    wgmma_ab_mn<D>(acck, sf, stage, it > 0);           // dk += ds^T q
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(accv);
  fence_regs(acck);
  fence_frags(pf);
  fence_frags(sf);

  const int c = layout_row_stride(heads, D);
  const int64_t base = layout_base(b, h, n, heads, D, c);
  const int64_t oa = base + static_cast<int64_t>(ja) * c + 2 * t;
  const int64_t ob = base + static_cast<int64_t>(jb) * c + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (ja < n) {
      *reinterpret_cast<uint32_t*>(dv + oa + 8 * j) = pack_bf16(accv[4 * j], accv[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dk + oa + 8 * j) =
          pack_bf16(__fmul_rn(acck[4 * j], scale), __fmul_rn(acck[4 * j + 1], scale));
    }
    if (jb < n) {
      *reinterpret_cast<uint32_t*>(dv + ob + 8 * j) = pack_bf16(accv[4 * j + 2], accv[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dk + ob + 8 * j) =
          pack_bf16(__fmul_rn(acck[4 * j + 2], scale), __fmul_rn(acck[4 * j + 3], scale));
    }
  }
}

// The ds workspace's row stride in floats: padded for the wgmma kernels
int ws_stride(int n, bool wgmma) { return wgmma ? (n + kWsAlign - 1) / kWsAlign * kWsAlign : n; }

// The ds workspace as a 3-D f32 map (n, n, planes) with rows ldw floats
// apart, boxes of 64 rows of 32 floats, 128 B swizzle
cudaError_t ws_tensor_map(EncodeTiled encode, CUtensorMap* map, float* ws, int planes, int n,
                          int ldw) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldw) * 4,
                                 static_cast<cuuint64_t>(ldw) * 4 * n};
  const cuuint32_t box[3] = {32, kWgTile, 1}, step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ws, dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The rows kernel, then the cols kernel on the rows kernel's statistics
// (kPair: X3's rows kernel)
template <int D, bool kPair>
int launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                 const void* dout, void* dq, void* dk, void* dv, float* ds_ws, float* stats,
                 int b, int n, int heads, float scale, cudaStream_t stream) {
  if ((n + kBlockRows - 1) / kBlockRows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int rows_smem = kRowsSmemBytes<D, kPair>, cols_smem = kColsSmemBytes<D>;
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  CUtensorMap tq, tk, tv, tdo, tws;
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tq, q, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tk, k, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tv, v, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) e = tensor_map<D>(encode, &tdo, dout, b, n, heads, kHeadMajor);
  if (e == cudaSuccess) e = ws_tensor_map(encode, &tws, ds_ws, b * heads, n, ws_stride(n, true));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(attention_long_bwd_rows_wgmma_kernel<D, kPair>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(attention_long_bwd_cols_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cols_smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b, heads, (n + kBlockRows - 1) / kBlockRows);
  attention_long_bwd_rows_wgmma_kernel<D, kPair>
      <<<grid, kWgThreads, rows_smem, stream>>>(tq, tk, tv, tdo, tws, bias,
                                                 static_cast<__nv_bfloat16*>(dq), stats, n, heads,
                                                 scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_long_bwd_cols_wgmma_kernel<D><<<grid, kWgThreads, cols_smem, stream>>>(
      tq, tk, tv, tdo, bias, stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
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

// rows: heads * n rows of n floats, ldw floats apart in the workspace
__global__ void attention_long_bwd_bias_sum_kernel(const float* __restrict__ ds_ws,
                                                   float* __restrict__ db, int64_t rows, int n,
                                                   int ldw, int b) {
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      float s = 0.f;
      for (int bi = 0; bi < b; ++bi) s += ds_ws[(bi * rows + row) * ldw + col];
      db[row * n + col] = s;
    }
  }
}

bool use_mma(const void* const* ptrs, int count, int d, int is_bf16) {
  uintptr_t all = 0;
  for (int i = 0; i < count; ++i) all |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return is_bf16 && wgmma_head_dim(d) && all % 16 == 0;
}

// q, k, v, dout, dq, dk, dv in the translation unit's layout, one dtype (bf16
// or f32); bias, db: (heads, n, n) f32; ds_ws: (b, heads, n, ws_stride(n))
// f32 scratch. The wgmma path also takes stats: (b, heads, ceil(n / 64), 3, 64) f32
// scratch (pc_ws unused); the scalar path pc_ws: (b, heads, n, n) scratch in
// the operands' dtype (stats unused). kPair (X3): the wgmma path with X3's
// products, and nothing else (any other launch returns cudaErrorInvalidValue).
template <bool kPair>
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
    if (d == 64) {
      rc = launch_wgmma<64, kPair>(q, k, v, bias, dout, dq, dk, dv, ds_ws, stats, b, n, heads,
                                   scale, stream);
    } else if constexpr (kPair) {
      return static_cast<int>(cudaErrorInvalidValue);   // X3's pair is D = 64 only
    } else {
      rc = launch_wgmma<32, false>(q, k, v, bias, dout, dq, dk, dv, ds_ws, stats, b, n, heads,
                                   scale, stream);
    }
  } else if constexpr (kPair) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (pc_ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    rc = is_bf16 ? launch_scalar<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws,
                                                b, n, heads, d, scale, stream)
                 : launch_scalar<float>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n,
                                        heads, d, scale, stream);
  }
  if (rc != 0) return rc;
  const int64_t rows = static_cast<int64_t>(heads) * n;
  attention_long_bwd_bias_sum_kernel<<<static_cast<int>(rows < 65535 ? rows : 65535), 256, 0,
                                       stream>>>(ds_ws, db, rows, n,
                                                 ws_stride(n, use_mma(ptrs, 7, d, is_bf16)), b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
