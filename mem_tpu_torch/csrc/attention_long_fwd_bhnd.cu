// K5b: softmax(q k^T * scale + bias_h) v on head-major (B, H, N, D) layouts
// for the shapes whose (H, N, N) f32 bias is above the head-blocked budget.
//
// Replaces mem_tpu/ops/attention.py:_fwd_kernel (the per-(batch, head)
// forward of fused_attention, called from _fa_fwd when _hb_eligible is
// false), which keeps one (b, h)'s whole (N, D) tiles, its (N, N) bias slice
// and a full (N, N) f32 score tile in VMEM. It computes K3f's function
// (attention.py:_fwd_flat_long_kernel) with other addressing: a head's rows
// are D elements apart instead of H*D, and head h of sample b starts at
// ((b*H + h)*N)*D instead of column h*D. So it is K3f's kernels
// (attention_long_fwd.cuh: for bf16 at D = 64 one pass over the keys with an
// online softmax on wgmma, K and V through a TMA ring, here with the
// head-major tensor map (64, N, B*H); scalar FMAs otherwise) compiled for that
// layout: the same arithmetic in the same order, and the same bits as K3f on
// transposed operands. No N limit: keys >= N are masked in the last tile,
// nothing is padded. What bounds it is what bounds K3f: device memory in
// principle (the bias), and the bias and K / V reads from L2 behind that.
//
// Seg backbone shapes under FLAT_ATTN = False or FLAT_ATTN_LONG = False:
// q, k, v (B, 12, 1025, 64) bf16, bias (12, 1025, 1025) f32. The head-blocked
// wrapper (ops/attention.py) also launches it for bf16 at D = 64 and
// 256 < N with the bias inside the budget, where K5a's tensor-core kernel
// has no instantiation.

#define MEM_ATTENTION_HEAD_MAJOR 1
#include "attention_long_fwd.cuh"

// q, k, v, out: (b, heads, n, d) in one dtype (bf16 or f32); bias: (heads, n, n) f32.
extern "C" int mem_attention_long_fwd_bhnd(const void* q, const void* k, const void* v,
                                           const float* bias, void* out, int b, int n,
                                           int heads, int d, float scale, int is_bf16,
                                           cudaStream_t stream) {
  return dispatch_long_fwd(q, k, v, bias, out, b, n, heads, d, scale, is_bf16, stream);
}
