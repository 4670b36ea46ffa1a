// K2b: the flat (B, N, H*D) entry points of the attention backward's scalar
// kernel (f32, head dims other than 64; bf16 at head dim 64 and N <= 256
// takes K3b's Hopper kernels, attention_long_bwd.cu), and of K2b's `mma.sync` tensor-core kernel, which no
// model path launches: X3 (attention_bwd_pair.cu) is held to it bit for bit.
// The kernels are in attention_bwd.cuh, the scalar one shared with the
// head-major (B, H, N, D) entry point of attention_bwd_bhnd.cu (K5c).

#include "attention_bwd.cuh"

extern "C" long long mem_attention_bwd_flat_smem(int n, int d, int is_bf16) {
  return bwd_smem_bytes(n, d, is_bf16);
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

// K2b's mma.sync kernel (attention_bwd_flat_mma_kernel: one block per
// (head, sample) in two phases over ds and p workspaces), then the bias sum.
// The arguments as mem_attention_bwd_flat's; bf16, d = 64, n <= 256 and
// 16-byte aligned operands only: any other launch returns
// cudaErrorInvalidValue and runs nothing.
extern "C" int mem_attention_bwd_flat_mma(const void* q, const void* k, const void* v,
                                          const float* bias, const void* dout, void* dq,
                                          void* dk, void* dv, float* db, float* ds_ws,
                                          void* pc_ws, int b, int n, int heads, int d,
                                          float scale, int is_bf16, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (b > 65535 || !use_mma(ptrs, 7, n, d, is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc;
  switch (mma_tiles(n)) {
    case 8: rc = launch_mma<8>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
    case 16: rc = launch_mma<16>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
    case 26: rc = launch_mma<26>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
    default: rc = launch_mma<32>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
  }
  return rc != 0 ? rc : launch_bias_sum(ds_ws, db, b, n, heads, stream);
}
