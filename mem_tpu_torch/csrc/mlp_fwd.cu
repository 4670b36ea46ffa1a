// K6f: the fused ViT MLP forward, out = gelu(T(x . W1 + b1)) . W2 + b2, with
// gelu(h) never in device memory and h stored once (the backward's
// residual) or, for inference, not at all.
//
// Replaces mem_tpu/ops/mlp.py:_fwd_kernel (called from _mlp_fwd_2d), which
// keeps both weights in VMEM and walks row tiles of 512 in order. The
// roundings are that kernel's: f32 sums, h rounded to the operand dtype T
// before gelu, gelu in f32 from that value with the polynomial erf, g
// rounded to T for the second product, out = T(o + b2).
//
// Finetune shape: x (25216, 768) bf16 (128 samples of 197 tokens), W1
// (768, 3072), W2 (3072, 768): 238 GFLOP against 242 MB with h (87 MB
// without), so operations bound it on the H100 (0.24 ms at the bf16 peak).
// The kernels are in mlp_rows.cuh, shared with the backward's first half;
// that file says what the design does and what bounds this version.
//
// The weights arrive as torch stores them, contiguous along the contraction:
// w1t (hidden, C) = W1^T and w2t (C, hidden) = W2^T.

#include "mlp_rows.cuh"

// 1 when a launch at these arguments takes the tensor-core kernel
extern "C" int mem_mlp_fwd_uses_mma(const void* x, const void* w1t, const void* b1,
                                    const void* w2t, const void* b2, const void* out,
                                    const void* h, int c, int hidden, int is_bf16) {
  const void* ptrs[7] = {x, w1t, b1, w2t, b2, out, h};
  return is_bf16 && mlp_mma_shape(c, hidden) && aligned16(ptrs, 7) ? 1 : 0;
}

// Bytes of dynamic shared memory a launch at width c may need (the larger of
// the two kernels' where both can take it).
extern "C" long long mem_mlp_rows_smem(int c, int hidden, int is_bf16) {
  size_t bytes = rows_smem(c);
  if (is_bf16 && mlp_mma_shape(c, hidden) && rows_mma_smem(c) > bytes) bytes = rows_mma_smem(c);
  return static_cast<long long>(bytes);
}

// x, out: (rows, c); w1t: (hidden, c); b1: (hidden); w2t: (c, hidden); b2:
// (c); h: (rows, hidden) or null; all in one dtype (bf16 or f32).
extern "C" int mem_mlp_fwd(const void* x, const void* w1t, const void* b1, const void* w2t,
                           const void* b2, void* out, void* h, int rows, int c, int hidden,
                           int is_bf16, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const bool mma = mem_mlp_fwd_uses_mma(x, w1t, b1, w2t, b2, out, h, c, hidden, is_bf16);
  return dispatch_rows<false>(mma, x, w1t, w2t, b1, b2, nullptr, h, out, rows, c, hidden,
                              is_bf16, stream);
}
