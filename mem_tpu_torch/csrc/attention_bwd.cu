// K2b: the flat (B, N, H*D) entry points of the attention backward. The
// kernels are in attention_bwd.cuh, shared with the head-major (B, H, N, D)
// entry point of attention_bwd_bhnd.cu (K5c).

#include "attention_bwd.cuh"

extern "C" long long mem_attention_bwd_flat_smem(int n, int d, int is_bf16) {
  return bwd_smem_bytes(n, d, is_bf16);
}

// 1 when a launch at these arguments takes the tensor-core kernel
extern "C" int mem_attention_bwd_flat_uses_mma(const void* q, const void* k, const void* v,
                                               const void* dout, const void* dq,
                                               const void* dk, const void* dv,
                                               int n, int d, int is_bf16) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  return use_mma(ptrs, 7, n, d, is_bf16) ? 1 : 0;
}

// q, k, v, dout, dq, dk, dv: (b, n, heads*d) in one dtype (bf16 or f32);
// bias: (heads, n, n) f32; db: (heads, n, n) f32; ds_ws: (b, heads, n, n)
// f32 and pc_ws: (b, heads, n, n) in the operands' dtype, both scratch.
extern "C" int mem_attention_bwd_flat(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, void* dq,
                                      void* dk, void* dv, float* db, float* ds_ws,
                                      void* pc_ws, int b, int n, int heads, int d,
                                      float scale, int is_bf16, cudaStream_t stream) {
  return dispatch_bwd(q, k, v, bias, dout, dq, dk, dv, db, ds_ws, pc_ws, b, n, heads,
                             d, scale, is_bf16, stream);
}
