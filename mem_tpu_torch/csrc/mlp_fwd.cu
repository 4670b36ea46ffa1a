// K6f: the fused ViT MLP forward, out = gelu(T(x . W1 + b1)) . W2 + b2, with h
// stored once (the backward's residual) or, for inference, not at all.
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
//
// bf16 at the model's widths (mlp_wgmma_shape) takes two launches of the
// Hopper GEMM body (gemm_sm90.cuh): F1 = x . W1 with the bias-gelu epilogue,
// which writes h (when asked) and g = T(gelu(hb)) to a (rows, hidden) bf16
// workspace the wrapper allocates, then F2 = g . W2 + b2. The TPU kernel
// keeps g out of device memory; here g makes one round trip (2 x 155 MB at
// the finetune shape, ~0.09 ms of memory time) so that gelu is evaluated
// once per element: a second product that applied gelu to its A operand on
// the way in would evaluate it C / BN = 3 times per element, and the first
// product's epilogue already costs about half its tensor-core time.
// f32 (the tests' dtype) and the other widths take the scalar kernel of
// mlp_rows.cuh.
//
// The weights arrive as torch stores them, contiguous along the contraction:
// w1t (hidden, C) = W1^T and w2t (C, hidden) = W2^T, the K-major B operands.

#include "gemm_sm90.cuh"
#include "mlp_rows.cuh"

namespace {

template <int BN, int kOcc>
__global__ void __launch_bounds__(kGemmThreads<kOcc>, kOcc)
mlp_gemm_f1_kernel(const __grid_constant__ GemmParams p) {
  gemm_body<kEpiBiasGelu, BN, kOcc>(p);
}

template <int BN, int kOcc>
__global__ void __launch_bounds__(kGemmThreads<kOcc>, kOcc)
mlp_gemm_f2_kernel(const __grid_constant__ GemmParams p) {
  gemm_body<kEpiBias, BN, kOcc>(p);
}

// F1's epilogue (bias, gelu, two outputs) costs about half as much as its
// products, so F1 runs two blocks of 128-column tiles on each SM (kOcc 2):
// one block's epilogue beside the other's products
int launch_f1(const GemmParams& p, cudaStream_t stream) {
  static bool opted_in = false;
  return gemm_launch<2>(mlp_gemm_f1_kernel<128, 2>, opted_in, p,
                        dim3((p.n + 127) / 128, (p.m + kGemmBM - 1) / kGemmBM), stream);
}

template <int BN>
int launch_f2(const GemmParams& p, cudaStream_t stream) {
  static bool opted_in = false;
  return gemm_launch<1>(mlp_gemm_f2_kernel<BN, 1>, opted_in, p,
                        dim3((p.n + BN - 1) / BN, (p.m + kGemmBM - 1) / kGemmBM), stream);
}

}  // namespace

// 1 when a launch at these arguments takes the Hopper GEMM ("wgmma"), 0 when
// it takes the scalar kernel
extern "C" int mem_mlp_fwd_path(const void* x, const void* w1t, const void* b1, const void* w2t,
                                const void* b2, const void* out, const void* h, int c,
                                int hidden, int is_bf16) {
  const void* ptrs[7] = {x, w1t, b1, w2t, b2, out, h};
  return is_bf16 && mlp_wgmma_shape(c, hidden) && aligned16(ptrs, 7) ? 1 : 0;
}

// Bytes of dynamic shared memory the scalar kernel needs at width c (both
// directions; the Hopper GEMM's are fixed and fit any block).
extern "C" long long mem_mlp_scalar_smem(int c) { return static_cast<long long>(rows_smem(c)); }

// x, out: (rows, c); w1t: (hidden, c); b1: (hidden); w2t: (c, hidden); b2:
// (c); h: (rows, hidden) or null; all in one dtype (bf16 or f32). g_ws:
// (rows, hidden) bf16 scratch on the Hopper path (null on the scalar one).
extern "C" int mem_mlp_fwd(const void* x, const void* w1t, const void* b1, const void* w2t,
                           const void* b2, void* out, void* h, void* g_ws, int rows, int c,
                           int hidden, int is_bf16, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (!mem_mlp_fwd_path(x, w1t, b1, w2t, b2, out, h, c, hidden, is_bf16)) {
    return dispatch_rows<false>(x, w1t, w2t, b1, b2, nullptr, h, out, rows, c, hidden, is_bf16,
                                stream);
  }
  if (g_ws == nullptr || reinterpret_cast<uintptr_t>(g_ws) % 16 != 0 ||
      (rows + kGemmBM - 1) / kGemmBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return static_cast<int>(e);
  GemmParams p1 = {}, p2 = {};
  // F1: hb = x . W1 (+ b1), B = w1t (hidden, c); h and g leave by TMA
  const int bn2 = gemm_bn(c);
  if ((e = gemm_map(encode, &p1.a[0], x, c, rows, kGemmBM)) != cudaSuccess ||
      (e = gemm_map(encode, &p1.b[0], w1t, c, hidden, 128)) != cudaSuccess ||
      (e = gemm_map(encode, &p1.out[0], h ? h : g_ws, hidden, rows, 64)) != cudaSuccess ||
      (e = gemm_map(encode, &p1.out[1], g_ws, hidden, rows, 64)) != cudaSuccess ||
      // F2: out = g . W2 + b2, B = w2t (c, hidden)
      (e = gemm_map(encode, &p2.a[0], g_ws, hidden, rows, kGemmBM)) != cudaSuccess ||
      (e = gemm_map(encode, &p2.b[0], w2t, hidden, c, bn2)) != cudaSuccess ||
      (e = gemm_map(encode, &p2.out[0], out, c, rows, 64)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  p1.bias = static_cast<const __nv_bfloat16*>(b1);
  p1.m = rows;
  p1.n = hidden;
  p1.k = c;
  p1.store_out0 = h != nullptr;
  p2.bias = static_cast<const __nv_bfloat16*>(b2);
  p2.m = rows;
  p2.n = c;
  p2.k = hidden;
  const int rc = launch_f1(p1, stream);
  if (rc != 0) return rc;
  return bn2 == 256 ? launch_f2<256>(p2, stream) : launch_f2<128>(p2, stream);
}
