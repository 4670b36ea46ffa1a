// K3b: the flat (B, N, H*D) entry points of the long attention backward. The
// kernels are in attention_long_bwd.cuh, shared with the head-major
// (B, H, N, D) entry points of attention_long_bwd_bhnd.cu (K5d, K5e). K2b
// launches mem_attention_long_bwd for bf16 at head dim 64 or 32 and N <= 256
// (counted under K2b's name).

#include "attention_long_bwd.cuh"

// The largest head dim the scalar kernels take.
extern "C" int mem_attention_long_bwd_max_d() { return kMaxScalarD; }

// Bytes of dynamic shared memory the scalar rows kernel needs at (n, d): it
// grows with n, and the wrapper refuses what a block may not use. The
// wgmma kernels use a fixed 148,536 B (rows: Q and dO, the ring, the ds
// staging buffers; X3's rows kernel 173,112 B, attention_bwd_pair.cu) and
// 86,072 B (columns) at any n at D = 64, 99,368 B and 35,880 B at D = 32.
// Either layout.
extern "C" long long mem_attention_long_bwd_scalar_smem(int n, int d) {
  return static_cast<long long>(scalar_smem_bytes(n, d));
}

// The row stride, in floats, of the (b, heads, n, stride) f32 ds workspace a
// launch needs: n rounded up to a multiple of 8 for the wgmma kernels
// (uses_mma 1), n for the scalar ones. Either layout.
extern "C" int mem_attention_long_bwd_ws_stride(int n, int uses_mma) {
  return ws_stride(n, uses_mma != 0);
}

// 1 when a launch at these arguments takes the wgmma kernels (either layout)
extern "C" int mem_attention_long_bwd_uses_mma(const void* q, const void* k, const void* v,
                                               const void* dout, const void* dq,
                                               const void* dk, const void* dv,
                                               int d, int is_bf16) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  return use_mma(ptrs, 7, d, is_bf16) ? 1 : 0;
}

// q, k, v, dout, dq, dk, dv: (b, n, heads*d) in one dtype (bf16 or f32);
// bias, db: (heads, n, n) f32; ds_ws: (b, heads, n,
// mem_attention_long_bwd_ws_stride(n, ...)) f32 scratch. The wgmma path also
// takes stats: (b, heads, ceil(n / 64), 3, 64) f32 scratch
// (pc_ws unused); the scalar path pc_ws: (b, heads, n, n) scratch in the
// operands' dtype (stats unused).
extern "C" int mem_attention_long_bwd(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, void* dq,
                                      void* dk, void* dv, float* db, float* ds_ws,
                                      void* pc_ws, float* stats, int b, int n, int heads,
                                      int d, float scale, int is_bf16, cudaStream_t stream) {
  return dispatch_long_bwd<false>(q, k, v, bias, dout, dq, dk, dv, db, ds_ws, pc_ws, stats, b, n,
                           heads, d, scale, is_bf16, stream);
}
