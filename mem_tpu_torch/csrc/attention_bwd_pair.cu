// X3: K2b's function with each head's two depth-64 products of phase 1,
// s = q k^T and dp = do v^T, taken as ONE depth-128 product
//
//   [q | do] (N x 2D) . [[k^T, 0], [0, v^T]] (2D x 2N) = [q k^T | do v^T]
//
// Replaces scripts/exp_attn_bwd.py:_bwd_flat_pair_kernel, the experiment
// that asks whether K2b (mem_tpu/ops/attention.py:_bwd_flat_kernel) gains by
// feeding the TPU's 128-deep matrix unit one full-depth product instead of
// two half-depth ones.
//
// On Hopper a wgmma k16 step costs the same whatever the product's depth, so
// the literal pair pays for its zero blocks; what it might buy is width. X3 is
// K2b's own Hopper body (attention_long_bwd.cuh: K3b's rows kernel, columns
// kernel and batch-order bias sum, which K2b launches at these shapes) with
// the pair in the rows kernel (kPair): each key tile's s and dp come from one
// m64n128k16 chain of eight k16 steps, [q | do] against a ring stage laid out
// K | Z | V (Z a zero tile, written once), instead of two m64n64k16 chains
// of four. The zero blocks are executed, as the TPU executes them: the rows
// kernel runs 2 x 4 N^2 D multiply-adds for the scores where K2b's runs
// 2 x 2 N^2 D, 13 N^2 D products' worth in all against K2b's 9 (the
// algorithm needs 5). Every sum gets exact zeros added in K2b's step order,
// so X3's dq, dk, dv and db are K2b's bits. The pair in the columns kernel
// too (s^T, dp^T = [k | v] . [[q^T, 0], [0, do^T]]) made that kernel slower
// and was dropped; the reference pairs only the products of its phase 1.
//
// Bound at the experiment's (128, 197, 12 x 64) bf16: 274.8 MB of traffic
// (0.082 ms at 3.35 TB/s) against 38.2 GFLOP for the five products; K2b's
// body is held by the bias loads and the ds workspace's round trip, not by
// its tensor cores. Allocates nothing and does not synchronise.

#include "attention_long_bwd.cuh"

// q, k, v, dout, dq, dk, dv: (b, n, heads*64) bf16; bias, db: (heads, n, n)
// f32; ds_ws: (b, heads, n, mem_attention_long_bwd_ws_stride(n, 1)) f32 and
// stats: (b, heads, ceil(n / 64), 3, 64) f32, both scratch. bf16, d = 64,
// n <= 256 and 16-byte aligned operands only (K2b's Hopper domain at the
// reference's head dim, where its pair lives): any other launch returns
// cudaErrorInvalidValue and runs nothing.
extern "C" int mem_attention_bwd_pair(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, void* dq, void* dk,
                                      void* dv, float* db, float* ds_ws, float* stats, int b,
                                      int n, int heads, int d, float scale, int is_bf16,
                                      cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (n > 256 || d != 64 || !use_mma(ptrs, 7, d, is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_long_bwd<true>(q, k, v, bias, dout, dq, dk, dv, db, ds_ws, nullptr, stats, b,
                                 n, heads, d, scale, is_bf16, stream);
}
