// K5c: dq, dk, dv and the batch-summed f32 bias gradient of
// o = softmax(q k^T * scale + bias_h) v on head-major (B, H, N, D) layouts.
//
// Replaces mem_tpu/ops/attention.py:_bwd_hb_kernel (the head-blocked VJP of
// fused_attention, called from _fa_bwd), which keeps all heads of a sample
// in VMEM, recomputes p per head and adds each sample's ds into one
// (H, N, N) block that the sequential batch grid revisits. It is K2b's
// function (attention.py:_bwd_flat_kernel) with other addressing. This unit
// is K2b's scalar kernel (attention_bwd.cuh: f32 operands and head dims other
// than 64; one block per (sample, head) in two phases over a (B, H, N, N)
// workspace, then the bias sum in batch order, no float atomics) compiled for
// the head-major layout: the same arithmetic in the same order, bit-identical
// across launches and to K2b on transposed operands. bf16 at D = 64 and N <=
// 256 takes K3b's Hopper kernels (attention_long_bwd_bhnd.cu).
//
// Finetune shapes: q, k, v, do (B, 12, 197, 64) bf16, bias and db
// (12, 197, 197) f32.

#define MEM_ATTENTION_HEAD_MAJOR 1
#include "attention_bwd.cuh"

// q, k, v, dout, dq, dk, dv: (b, heads, n, d) in one dtype (bf16 or f32);
// bias, db: (heads, n, n) f32; ds_ws: (b, heads, n, n) f32 and pc_ws:
// (b, heads, n, n) in the operands' dtype, both scratch.
extern "C" int mem_attention_bwd_bhnd(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, void* dq,
                                      void* dk, void* dv, float* db, float* ds_ws,
                                      void* pc_ws, int b, int n, int heads, int d,
                                      float scale, int is_bf16, cudaStream_t stream) {
  return dispatch_bwd(q, k, v, bias, dout, dq, dk, dv, db, ds_ws, pc_ws, b, n, heads,
                            d, scale, is_bf16, stream);
}
