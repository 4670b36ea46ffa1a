// K2f: the flat (B, N, H*D) entry points of the attention forward's scalar
// kernel (f32, head dims other than 64; bf16 at head dim 64 and N <= 256
// takes K3f's Hopper kernel, attention_long_fwd.cu). The kernel is in attention_fwd.cuh, shared with
// the head-major (B, H, N, D) entry point of attention_fwd_bhnd.cu (K5a).

#include "attention_fwd.cuh"

extern "C" long long mem_attention_fwd_flat_smem(int n, int d, int is_bf16) {
  return fwd_smem_bytes(n, d, is_bf16);
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

// Makes ``device``'s primary context current on the calling thread for this
// library's CUDA runtime (linked statically, so it keeps its own per-thread
// state beside PyTorch's). A thread on which PyTorch has not touched the card
// yet -- a fresh thread, or autograd's device thread when its first work is
// one of these kernels -- has no current context, and the TMA kernels' launch
// then fails with cudaErrorInvalidValue; on a card other than device 0 every
// launch would go to device 0's context.
extern "C" int mem_cuda_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
