// K6b: the fused ViT MLP backward. From (do, h, x, W1, W2):
//   g   = T(gelu(f32(h)))                recomputed from the stored h
//   dh  = T((do . W2^T) * gelu'(f32(h)))
//   dx  = T(dh . W1^T)
//   dW2 = g^T . do,  db2 = sum_r do      f32, summed over all rows
//   dW1 = x^T . dh,  db1 = sum_r dh      f32, summed over all rows
// (T is the operand dtype; every sum is f32.)
//
// Replaces mem_tpu/ops/mlp.py:_bwd_kernel (called from _mlp_bwd_2d), which
// walks the row tiles in order and adds each tile's weight and bias
// gradients into f32 blocks that the sequential grid revisits.
//
// Finetune shape: rows 25216, C 768, hidden 3072, bf16: 476 GFLOP against
// ~300 MB, so operations bound it on the H100 (0.48 ms at the bf16 peak).
//
// What is hard, and what the design does: dW1, dW2, db1 and db2 are sums
// over every row, a Hopper grid has no order, and the port uses no float
// atomics (results are bit-identical from launch to launch). bf16 at the
// model's widths (mlp_wgmma_shape) takes three launches of the Hopper GEMM
// body (gemm_sm90.cuh) and two short passes:
//   B1  dg = do . W2^T (B = W2 (hidden, C) as the reference stores it), whose
//       epilogue reads the h tile and writes dh = T(dg * gelu'(h)) and
//       g = T(gelu(h)) to (rows, hidden) bf16 workspaces;
//   B2  dx = T(dh . W1^T) (B = W1 (C, hidden));
//   B3+B4 in one launch: dW2 = g^T . do and dW1^T = dh^T . x, every operand
//       read MN-major (the rows are the contraction), the rows cut into the
//       wrapper's fixed chunks (a multiple of 64 rows each, a function of the
//       row count alone: 72 output tiles of 128 x 256 a product are too few
//       for 132 SMs), one f32 partial per (product, chunk);
//   colsum: the column sums of dh and do over blocks of ``cs_rows`` rows,
//       each block's rows in order, one f32 partial per block;
//   sum: dW2 and dW1^T as the partials added in chunk order, db1 and db2 as
//       the colsum partials added in block order.
// Every order is fixed by the shapes, so each gradient is the same sum from
// launch to launch. The f32 partials cost 2 x chunks x 9.4 MB of writes and
// reads (4 chunks at the finetune shape: 0.05 ms of memory time).
//
// f32 (the tests' dtype) and the other widths take the scalar kernels: the
// rows kernel of mlp_rows.cuh (dh to the workspace, dx) and the columns
// kernel below, which owns a 32 x 32 tile of a weight gradient and goes over
// all rows in order: out[j][c] = sum_r P[r][j] Q[r][c], with (P, Q) =
// (gelu(h), do) for dW2 and (dh, x) for dW1^T; the blocks of the first tile
// column add P's columns (db1), those of the first tile row Q's (db2), one
// thread per column, in row order.
// The weights arrive contiguous along each product's contraction: w2
// (hidden, C) and w1 (C, hidden), as the reference stores them; dW2 comes
// out (hidden, C) and dW1 transposed, (hidden, C), which is how torch stores
// the fc1 weight.

#include "gemm_sm90.cuh"
#include "mlp_rows.cuh"

namespace {

// ---------------------------------------------------------------------------
// Hopper path: B1, B2, B3+B4 on gemm_sm90.cuh's body, then colsum and sum
// ---------------------------------------------------------------------------

template <int BN, int kOcc>
__global__ void __launch_bounds__(kGemmThreads<kOcc>, kOcc)
mlp_gemm_b1_kernel(const __grid_constant__ GemmParams p) {
  gemm_body<kEpiGeluGrad, BN, kOcc>(p);
}

template <int BN, int kOcc>
__global__ void __launch_bounds__(kGemmThreads<kOcc>, kOcc)
mlp_gemm_b2_kernel(const __grid_constant__ GemmParams p) {
  gemm_body<kEpiPlain, BN, kOcc>(p);
}

template <int BN, int kOcc>
__global__ void __launch_bounds__(kGemmThreads<kOcc>, kOcc)
mlp_gemm_wgrad_kernel(const __grid_constant__ GemmParams p) {
  gemm_body<kEpiWgrad, BN, kOcc>(p);
}

// Column sums of dh (columns 0 .. hidden - 1) and do (hidden .. hidden + c -
// 1) over the rows of block blockIdx.y, in row order; two columns a thread.
// cs: (blocks, hidden + c) f32.
__global__ void __launch_bounds__(256)
mlp_colsum_kernel(const __nv_bfloat16* __restrict__ dh, const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ cs, int rows, int hidden, int c, int cs_rows) {
  const int col = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (col >= hidden + c) return;
  const bool in_h = col < hidden;
  const int ld = in_h ? hidden : c;
  const __nv_bfloat16* src = in_h ? dh + col : dout + (col - hidden);
  const int r0 = blockIdx.y * cs_rows, r1 = min(rows, r0 + cs_rows);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(src + static_cast<int64_t>(r) * ld);
    s0 += __low2float(v);
    s1 += __high2float(v);
  }
  *reinterpret_cast<float2*>(cs + static_cast<int64_t>(blockIdx.y) * (hidden + c) + col) =
      make_float2(s0, s1);
}

// dW2 and dW1^T: each element the sum of its ``chunks`` partials in chunk
// order (part: (2, chunks, hidden * c) f32, four elements a thread); then
// db1 and db2: each column the sum of the ``blocks`` colsum partials in
// block order.
__global__ void __launch_bounds__(256)
mlp_wgrad_sum_kernel(const float* __restrict__ part, const float* __restrict__ cs,
                     float* __restrict__ dw2, float* __restrict__ dw1t, float* __restrict__ db1,
                     float* __restrict__ db2, int hidden, int c, int chunks, int blocks) {
  const int64_t per4 = static_cast<int64_t>(hidden) * c / 4;   // float4s of one product
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < 2 * per4) {
    const int prod = static_cast<int>(i / per4);
    const int64_t e = i % per4;
    const float4* src = reinterpret_cast<const float4*>(part) + prod * chunks * per4 + e;
    float4 acc = src[0];
    for (int s = 1; s < chunks; ++s) {
      const float4 v = src[s * per4];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(prod == 0 ? dw2 : dw1t)[e] = acc;
    return;
  }
  const int64_t col = i - 2 * per4;
  if (col >= hidden + c) return;
  float acc = 0.f;
  for (int q = 0; q < blocks; ++q) acc += cs[static_cast<int64_t>(q) * (hidden + c) + col];
  if (col < hidden) {
    db1[col] = acc;
  } else {
    db2[col - hidden] = acc;
  }
}

// B1's epilogue (h, gelu and gelu', two outputs) costs about half as much
// as its products, so B1 runs two blocks of 128-column tiles on each SM
// (kOcc 2): one block's epilogue beside the other's products
int launch_b1(const GemmParams& p, cudaStream_t stream) {
  static bool opted_in = false;
  return gemm_launch<2>(mlp_gemm_b1_kernel<128, 2>, opted_in, p,
                        dim3((p.n + 127) / 128, (p.m + kGemmBM - 1) / kGemmBM), stream);
}

template <int BN>
int launch_b2(const GemmParams& p, cudaStream_t stream) {
  static bool opted_in = false;
  return gemm_launch<1>(mlp_gemm_b2_kernel<BN, 1>, opted_in, p,
                        dim3((p.n + BN - 1) / BN, (p.m + kGemmBM - 1) / kGemmBM), stream);
}

template <int BN>
int launch_wgrad(const GemmParams& p, cudaStream_t stream) {
  static bool opted_in = false;
  return gemm_launch<1>(mlp_gemm_wgrad_kernel<BN, 1>, opted_in, p,
                        dim3((p.n + BN - 1) / BN, p.m / kGemmBM, 2 * p.chunks), stream);
}

int launch_hopper(const void* dout, const void* h, const void* x, const void* w1,
                  const void* w2, void* dx, float* dw1t, float* dw2, float* db1, float* db2,
                  void* dh_ws, void* g_ws, float* part_ws, float* cs_ws, int rows, int c,
                  int hidden, int chunk_rows, int chunks, int cs_rows, cudaStream_t stream) {
  // the plan must cover every row exactly once, in whole 64-row steps
  const int blocks = (rows + cs_rows - 1) / max(cs_rows, 1);
  if (g_ws == nullptr || part_ws == nullptr || cs_ws == nullptr || chunk_rows <= 0 ||
      chunk_rows % kGemmBK != 0 || chunks <= 0 || 2 * chunks > 65535 ||
      static_cast<int64_t>(chunks - 1) * chunk_rows >= rows ||
      static_cast<int64_t>(chunks) * chunk_rows < rows || cs_rows <= 0 || blocks > 65535 ||
      (rows + kGemmBM - 1) / kGemmBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ws[3] = {g_ws, part_ws, cs_ws};
  if (!aligned16(ws, 3)) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bnc = gemm_bn(c);
  GemmParams p1 = {}, p2 = {}, p3 = {};
  if (  // B1: dg = do . W2^T, B = w2 (hidden, c); dh and g leave by TMA
      (e = gemm_map(encode, &p1.a[0], dout, c, rows, kGemmBM)) != cudaSuccess ||
      (e = gemm_map(encode, &p1.b[0], w2, c, hidden, 128)) != cudaSuccess ||
      (e = gemm_map(encode, &p1.out[0], dh_ws, hidden, rows, 64)) != cudaSuccess ||
      (e = gemm_map(encode, &p1.out[1], g_ws, hidden, rows, 64)) != cudaSuccess ||
      // B2: dx = dh . W1^T, B = w1 (c, hidden)
      (e = gemm_map(encode, &p2.a[0], dh_ws, hidden, rows, kGemmBM)) != cudaSuccess ||
      (e = gemm_map(encode, &p2.b[0], w1, hidden, c, bnc)) != cudaSuccess ||
      (e = gemm_map(encode, &p2.out[0], dx, c, rows, 64)) != cudaSuccess ||
      // B3: dW2 = g^T . do and B4: dW1^T = dh^T . x, 64 x 64 boxes of the
      // (rows, hidden) and (rows, c) matrices
      (e = gemm_map(encode, &p3.a[0], g_ws, hidden, rows, 64)) != cudaSuccess ||
      (e = gemm_map(encode, &p3.b[0], dout, c, rows, 64)) != cudaSuccess ||
      (e = gemm_map(encode, &p3.a[1], dh_ws, hidden, rows, 64)) != cudaSuccess ||
      (e = gemm_map(encode, &p3.b[1], x, c, rows, 64)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  p1.h = static_cast<const __nv_bfloat16*>(h);
  p1.m = rows;
  p1.n = hidden;
  p1.k = c;
  p2.m = rows;
  p2.n = c;
  p2.k = hidden;
  p3.part = part_ws;
  p3.m = hidden;
  p3.n = c;
  p3.k = rows;
  p3.chunk_rows = chunk_rows;
  p3.chunks = chunks;
  int rc = launch_b1(p1, stream);
  if (rc != 0) return rc;
  rc = bnc == 256 ? launch_b2<256>(p2, stream) : launch_b2<128>(p2, stream);
  if (rc != 0) return rc;
  rc = bnc == 256 ? launch_wgrad<256>(p3, stream) : launch_wgrad<128>(p3, stream);
  if (rc != 0) return rc;
  using B = __nv_bfloat16;
  mlp_colsum_kernel<<<dim3((hidden + c + 511) / 512, blocks), 256, 0, stream>>>(
      static_cast<const B*>(dh_ws), static_cast<const B*>(dout), cs_ws, rows, hidden, c, cs_rows);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int64_t threads = static_cast<int64_t>(hidden) * c / 2 + hidden + c;
  mlp_wgrad_sum_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      part_ws, cs_ws, dw2, dw1t, db1, db2, hidden, c, chunks, blocks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// scalar path: the columns kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 32;

template <typename T, bool kGelu>
__global__ void __launch_bounds__(kThreads)
mlp_cols_kernel(const T* __restrict__ p, const T* __restrict__ qm, float* __restrict__ dw,
                float* __restrict__ dbp, float* __restrict__ dbq, int rows, int hidden,
                int c) {
  __shared__ float ps[kTile][kTile + 1];
  __shared__ float qs[kTile][kTile + 1];
  const int j0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;   // ty 0..7
  const bool sum_p = dbp != nullptr && blockIdx.x == 0 && threadIdx.x < kTile;
  const bool sum_q = dbq != nullptr && blockIdx.y == 0 && threadIdx.x >= kTile &&
                     threadIdx.x < 2 * kTile;
  float bsum = 0.f;
  float acc[kTile / 8] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < rows; k0 += kTile) {
    __syncthreads();
    for (int i = 0; i < kTile / 8; ++i) {
      const int r = ty + 8 * i;
      const int64_t row = k0 + r;
      float pv = 0.f, qv = 0.f;
      if (row < rows && j0 + tx < hidden) {
        pv = to_f32(p[row * hidden + j0 + tx]);
        if (kGelu) pv = to_f32(from_f32<T>(gelu_poly(pv)));
      }
      if (row < rows && c0 + tx < c) qv = to_f32(qm[row * c + c0 + tx]);
      ps[r][tx] = pv;
      qs[r][tx] = qv;
    }
    __syncthreads();
    if (sum_p) {
      for (int r = 0; r < kTile; ++r) bsum += ps[r][threadIdx.x];
    }
    if (sum_q) {
      for (int r = 0; r < kTile; ++r) bsum += qs[r][threadIdx.x - kTile];
    }
    for (int r = 0; r < kTile; ++r) {
      const float qv = qs[r][tx];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) acc[i] = fmaf(ps[r][ty + 8 * i], qv, acc[i]);
    }
  }
  for (int i = 0; i < kTile / 8; ++i) {
    const int64_t j = j0 + ty + 8 * i;
    if (j < hidden && c0 + tx < c) dw[j * c + c0 + tx] = acc[i];
  }
  if (sum_p && j0 + threadIdx.x < hidden) dbp[j0 + threadIdx.x] = bsum;
  if (sum_q && c0 + threadIdx.x - kTile < c) dbq[c0 + threadIdx.x - kTile] = bsum;
}

template <bool kGelu>
int launch_cols(const void* p, const void* qm, float* dw, float* dbp, float* dbq, int rows,
                int hidden, int c, int is_bf16, cudaStream_t stream) {
  const dim3 grid((c + kTile - 1) / kTile, (hidden + kTile - 1) / kTile);
  if (is_bf16) {
    using B = __nv_bfloat16;
    mlp_cols_kernel<B, kGelu><<<grid, kThreads, 0, stream>>>(
        static_cast<const B*>(p), static_cast<const B*>(qm), dw, dbp, dbq, rows, hidden, c);
  } else {
    mlp_cols_kernel<float, kGelu><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(p), static_cast<const float*>(qm), dw, dbp, dbq, rows, hidden,
        c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a launch at these arguments takes the Hopper GEMM ("wgmma"), 0 when
// it takes the scalar kernels
extern "C" int mem_mlp_bwd_path(const void* dout, const void* h, const void* x, const void* w1,
                                const void* w2, const void* dx, const void* dh_ws, int c,
                                int hidden, int is_bf16) {
  const void* ptrs[7] = {dout, h, x, w1, w2, dx, dh_ws};
  return is_bf16 && mlp_wgmma_shape(c, hidden) && aligned16(ptrs, 7) ? 1 : 0;
}

// dout, x, dx: (rows, c); h, dh_ws (scratch): (rows, hidden); w1: (c, hidden);
// w2: (hidden, c); all in one dtype (bf16 or f32). dw1t, dw2: (hidden, c) f32;
// db1: (hidden) f32; db2: (c) f32. The Hopper path's scratch (null on the
// scalar path): g_ws (rows, hidden) bf16, part_ws (2, chunks, hidden, c) f32,
// cs_ws (ceil(rows / cs_rows), hidden + c) f32; chunk_rows and chunks are the
// weight gradients' row plan, cs_rows the colsum's block of rows.
extern "C" int mem_mlp_bwd(const void* dout, const void* h, const void* x, const void* w1,
                           const void* w2, void* dx, float* dw1t, float* dw2, float* db1,
                           float* db2, void* dh_ws, void* g_ws, float* part_ws, float* cs_ws,
                           int rows, int c, int hidden, int chunk_rows, int chunks, int cs_rows,
                           int is_bf16, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);   // the sums would be unset
  if (mem_mlp_bwd_path(dout, h, x, w1, w2, dx, dh_ws, c, hidden, is_bf16)) {
    return launch_hopper(dout, h, x, w1, w2, dx, dw1t, dw2, db1, db2, dh_ws, g_ws, part_ws,
                         cs_ws, rows, c, hidden, chunk_rows, chunks, cs_rows, stream);
  }
  if ((hidden + kTile - 1) / kTile > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int rc = dispatch_rows<true>(dout, w2, w1, nullptr, nullptr, h, dh_ws, dx, rows, c, hidden,
                               is_bf16, stream);
  if (rc != 0) return rc;
  rc = launch_cols<true>(h, dout, dw2, nullptr, db2, rows, hidden, c, is_bf16, stream);
  if (rc != 0) return rc;
  return launch_cols<false>(dh_ws, x, dw1t, db1, nullptr, rows, hidden, c, is_bf16, stream);
}
