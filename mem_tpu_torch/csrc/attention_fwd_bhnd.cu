// K5a: softmax(q k^T * scale + bias_h) v on head-major (B, H, N, D) layouts.
//
// Replaces mem_tpu/ops/attention.py:_fwd_hb_kernel (the head-blocked forward
// of fused_attention, called from _fa_fwd), which keeps all heads of one
// sample and the whole (H, N, N) f32 bias in VMEM and loops over the heads.
// It computes K2f's function (attention.py:_fwd_flat_kernel) with other
// addressing: a head's rows are D elements apart instead of H*D, and head h
// of sample b starts at ((b*H + h)*N)*D instead of column h*D. This unit is
// K2f's scalar kernel (attention_fwd.cuh: f32 operands and head dims other
// than 64) compiled for that layout: the same arithmetic in the same order,
// and the same bits as K2f on transposed operands. bf16 at D = 64 and N <=
// 256 takes K3f's Hopper kernel (attention_long_fwd_bhnd.cu).

#define MEM_ATTENTION_HEAD_MAJOR 1
#include "attention_fwd.cuh"

// q, k, v, out: (b, heads, n, d) in one dtype (bf16 or f32); bias: (heads, n, n) f32.
extern "C" int mem_attention_fwd_bhnd(const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* out, int b, int n, int heads,
                                      int d, float scale, int is_bf16,
                                      cudaStream_t stream) {
  return dispatch_fwd(q, k, v, bias, out, b, n, heads, d, scale, is_bf16, stream);
}
