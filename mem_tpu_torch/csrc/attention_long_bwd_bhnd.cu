// K5d and K5e: dq, dk, dv and the batch-summed f32 bias gradient of
// o = softmax(q k^T * scale + bias_h) v on head-major (B, H, N, D) layouts
// for the shapes whose (H, N, N) f32 bias is above the head-blocked budget.
//
// Replace mem_tpu/ops/attention.py:_bwd_kernel (K5d: the whole-matrix VJP of
// fused_attention, one (h, b) per grid step with the batch trailing, taken
// at N <= _WHOLE_BWD_MAX_N = 448) and _bwd_block_merged_kernel (K5e: the
// row-blocked VJP above that, grid (H, QB, B) over 256-row query blocks with
// N padded to a multiple of 256 and keys >= N masked, dk / dv written as
// per-block partials rounded to the operand dtype and summed outside in
// f32), both called from _fa_bwd. The two compute one function, and it is
// K3b's (attention.py:_bwd_flat_long_kernel) with other addressing, so both
// entry points below are K3b's kernels (attention_long_bwd.cuh: for bf16 at
// D = 64 a rows kernel for ds and dq and a columns kernel for dk and dv on
// wgmma, tiles through TMA rings with the head-major tensor map (64, N, B*H),
// no N limit and no padding, then db summed over the batch in batch order
// from an f32 ds workspace, no float atomics) compiled for the head-major layout:
// the same arithmetic in the same order, bit-identical across launches and
// to K3b on transposed operands. K5e's one difference from the TPU kernel is
// K3b's: dk and dv are summed in f32 over all rows and rounded once, not per
// 256-row block. Two entry points, so that a launch count shows which of the
// reference's branches ran. Bound as K3b: operations at the seg shape (nine
// products where the function needs five) and the workspace round trip.
//
// Shapes: the seg backbone under FLAT_ATTN = False or FLAT_ATTN_LONG = False,
// q, k, v, do (16, 12, 1025, 64) bf16, bias and db (12, 1025, 1025) f32 (K5e);
// a finetune at --input_size 320, (B, 12, 401, 64) (K5d). The head-blocked
// wrapper (ops/attention.py) takes the K5d entry for every bf16 launch at
// D = 64 (the finetune's (B, 12, 197, 64) under FLAT_ATTN = False included),
// counted under K5c's name.

#define MEM_ATTENTION_HEAD_MAJOR 1
#include "attention_long_bwd.cuh"

// q, k, v, dout, dq, dk, dv: (b, heads, n, d) in one dtype (bf16 or f32);
// bias, db: (heads, n, n) f32; ds_ws: (b, heads, n,
// mem_attention_long_bwd_ws_stride(n, ...)) f32 scratch; stats
// (b, heads, ceil(n / 64), 3, 64) f32 for the wgmma path, pc_ws (b, heads, n,
// n) in the operands' dtype for the scalar one (mem_attention_long_bwd_uses_mma
// says which).
extern "C" int mem_attention_bwd_whole_bhnd(const void* q, const void* k, const void* v,
                                            const float* bias, const void* dout, void* dq,
                                            void* dk, void* dv, float* db, float* ds_ws,
                                            void* pc_ws, float* stats, int b, int n, int heads,
                                            int d, float scale, int is_bf16,
                                            cudaStream_t stream) {
  return dispatch_long_bwd(q, k, v, bias, dout, dq, dk, dv, db, ds_ws, pc_ws, stats, b, n,
                           heads, d, scale, is_bf16, stream);
}

// The same arguments as mem_attention_bwd_whole_bhnd, for the K5e branch.
extern "C" int mem_attention_bwd_blocked_bhnd(const void* q, const void* k, const void* v,
                                              const float* bias, const void* dout, void* dq,
                                              void* dk, void* dv, float* db, float* ds_ws,
                                              void* pc_ws, float* stats, int b, int n,
                                              int heads, int d, float scale, int is_bf16,
                                              cudaStream_t stream) {
  return dispatch_long_bwd(q, k, v, bias, dout, dq, dk, dv, db, ds_ws, pc_ws, stats, b, n,
                           heads, d, scale, is_bf16, stream);
}
