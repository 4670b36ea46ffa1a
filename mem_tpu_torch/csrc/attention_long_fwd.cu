// K3f: the flat (B, N, H*D) entry points of the long attention forward. The
// kernels are in attention_long_fwd.cuh, shared with the head-major
// (B, H, N, D) entry point of attention_long_fwd_bhnd.cu (K5b). K2f launches
// the same entry point for bf16 at head dim 64 or 32 and N <= 256
// (ops/attention.py counts those launches under K2f's name): at that N the
// ring takes a (b, h)'s whole K and V in the first round at D = 64 (three
// stages of four tiles at N = 197: the producer waits for one).

#include "attention_long_fwd.cuh"

// The largest head dim the scalar kernel takes.
extern "C" int mem_attention_long_fwd_max_d() { return kMaxScalarD; }

// 1 when a launch at these arguments takes the wgmma kernel (either layout)
extern "C" int mem_attention_long_fwd_uses_mma(const void* q, const void* k,
                                               const void* v, const void* out,
                                               int d, int is_bf16) {
  return use_mma(q, k, v, out, d, is_bf16) ? 1 : 0;
}

// q, k, v, out: (b, n, heads*d) in one dtype (bf16 or f32); bias: (heads, n, n) f32.
extern "C" int mem_attention_long_fwd(const void* q, const void* k, const void* v,
                                      const float* bias, void* out, int b, int n,
                                      int heads, int d, float scale, int is_bf16,
                                      cudaStream_t stream) {
  return dispatch_long_fwd(q, k, v, bias, out, b, n, heads, d, scale, is_bf16, stream);
}
