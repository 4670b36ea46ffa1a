// K2f: the flat (B, N, H*D) entry points of the attention forward. The
// kernels are in attention_fwd.cuh, shared with the head-major (B, H, N, D)
// entry points of attention_fwd_bhnd.cu (K5a).

#include "attention_fwd.cuh"

extern "C" long long mem_attention_fwd_flat_smem(int n, int d, int is_bf16) {
  return fwd_smem_bytes(n, d, is_bf16);
}

// 1 when a launch at these arguments takes the tensor-core kernel
extern "C" int mem_attention_fwd_flat_uses_mma(const void* q, const void* k,
                                               const void* v, const void* out,
                                               int n, int d, int is_bf16) {
  return use_mma(q, k, v, out, n, d, is_bf16) ? 1 : 0;
}

// q, k, v, out: (b, n, heads*d) in one dtype (bf16 or f32); bias: (heads, n, n) f32.
extern "C" int mem_attention_fwd_flat(const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* out, int b, int n, int heads,
                                      int d, float scale, int is_bf16,
                                      cudaStream_t stream) {
  return dispatch_fwd(q, k, v, bias, out, b, n, heads, d, scale, is_bf16, stream);
}

extern "C" const char* mem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
