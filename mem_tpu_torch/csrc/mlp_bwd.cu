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
// over every row tile, a Hopper grid has no order, and the port uses no
// float atomics (results are bit-identical from launch to launch). So the
// work is cut twice:
// - the rows kernel (mlp_rows.cuh, the forward's body with another
//   elementwise step) owns a tile of rows: dg = do . W2^T step by step,
//   dh = T(dg * gelu'(h)), dx = dh . W1^T; it writes dh to a (rows, hidden)
//   workspace in T (155 MB at the finetune shape);
// - the columns kernel (below) owns a 128 x 128 tile of a weight gradient
//   and goes over all rows in order: out[j][c] = sum_r P[r][j] Q[r][c], with
//   (P, Q) = (gelu(h), do) for dW2 and (dh, x) for dW1^T; the blocks of the
//   first tile column add P's columns (db1), those of the first tile row
//   Q's (db2), one thread per column, in row order.
// Recomputed: gelu(h) once per 128-column tile of C (6 times at C = 768),
// gelu'(h) once. Read again from device memory or L2: h and dh C/128 times,
// do and x hidden/128 times.
//
// mlp_cols_mma_kernel (bf16, widths that are multiples of 128): 8 warps, 64
// rows per step; both operands are staged TRANSPOSED in shared memory
// ([column][row], row pairs packed in 32-bit words, stride 72 elements so
// the fragment loads hit 32 banks), which makes them the row-major A and
// "col" B operands of mma.sync m16n8k16 with k = rows; a warp holds a
// 32 x 64 piece of the tile (64 f32 registers). mlp_cols_kernel (everything
// else, f32 included): a 32 x 32 tile per block from f32 staging, scalar
// FMAs. The weights arrive contiguous along each product's contraction: w2
// (hidden, C) and w1 (C, hidden), as the reference stores them; dW2 comes
// out (hidden, C) and dW1 transposed, (hidden, C), which is how torch stores
// the fc1 weight.

#include "mlp_rows.cuh"

namespace {

// ---------------------------------------------------------------------------
// columns kernel, tensor cores
// ---------------------------------------------------------------------------

constexpr int kColsTile = 128;    // columns of P and of Q per block
constexpr int kColsRows = 64;     // rows per step
constexpr int kColsStride = kColsRows + 8;   // 36 words: 8 columns x 4 lanes on 32 banks

// Stage 64 rows x 128 columns of m (row stride ld, first row k0, first column
// col0) transposed into dst[128][kColsStride]; rows past the end as zeros.
template <bool kGelu>
__device__ __forceinline__ void stage_transposed(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* __restrict__ m, int ld,
                                                 int k0, int col0, int rows) {
  // a warp takes 8 row pairs x 4 segments of 8 columns: 64 B per row from
  // device memory, and per store 8 neighbouring words x 4 segments
  for (int item = threadIdx.x; item < (kColsRows / 2) * (kColsTile / 8);
       item += kMmaThreads) {
    const int lane = item % 32, wi = item / 32;
    const int rp = (wi / 4) * 8 + lane % 8;       // row pair 0..31
    const int seg = ((wi % 4) * 4 + lane / 8) * 8;   // first of 8 columns
    const int r = k0 + 2 * rp;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (r < rows) {
      lo = *reinterpret_cast<const uint4*>(m + static_cast<int64_t>(r) * ld + col0 + seg);
    }
    if (r + 1 < rows) {
      hi = *reinterpret_cast<const uint4*>(m + static_cast<int64_t>(r + 1) * ld + col0 + seg);
    }
    const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t hw[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t even, odd;   // columns seg + 2e and seg + 2e + 1, rows (r, r + 1)
      if (kGelu) {
        even = pack_bf16(gelu_poly(bf16_lo(lw[e])), gelu_poly(bf16_lo(hw[e])));
        odd = pack_bf16(gelu_poly(bf16_hi(lw[e])), gelu_poly(bf16_hi(hw[e])));
      } else {
        even = (lw[e] & 0xffffu) | (hw[e] << 16);
        odd = (lw[e] >> 16) | (hw[e] & 0xffff0000u);
      }
      *reinterpret_cast<uint32_t*>(dst + (seg + 2 * e) * kColsStride + 2 * rp) = even;
      *reinterpret_cast<uint32_t*>(dst + (seg + 2 * e + 1) * kColsStride + 2 * rp) = odd;
    }
  }
}

template <bool kGelu>
__global__ void __launch_bounds__(kMmaThreads)
mlp_cols_mma_kernel(const __nv_bfloat16* __restrict__ p,   // (rows, hidden): h or dh
                    const __nv_bfloat16* __restrict__ qm,  // (rows, c): do or x
                    float* __restrict__ dw,                // (hidden, c)
                    float* __restrict__ dbp,               // (hidden) or null
                    float* __restrict__ dbq,               // (c) or null
                    int rows, int hidden, int c) {
  __shared__ __align__(16) __nv_bfloat16 pt[kColsTile * kColsStride];
  __shared__ __align__(16) __nv_bfloat16 qt[kColsTile * kColsStride];
  const int j0 = blockIdx.y * kColsTile;   // first hidden column
  const int c0 = blockIdx.x * kColsTile;   // first output column
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  const bool sum_p = dbp != nullptr && blockIdx.x == 0 && threadIdx.x < kColsTile;
  const bool sum_q = dbq != nullptr && blockIdx.y == 0 && threadIdx.x >= kColsTile;
  float bsum = 0.f;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  for (int k0 = 0; k0 < rows; k0 += kColsRows) {
    __syncthreads();   // the previous step's reads are done
    stage_transposed<kGelu>(pt, p, hidden, k0, j0, rows);
    stage_transposed<false>(qt, qm, c, k0, c0, rows);
    __syncthreads();
    if (sum_p || sum_q) {   // one thread per column, rows in order
      const __nv_bfloat16* col = sum_p ? pt + threadIdx.x * kColsStride
                                       : qt + (threadIdx.x - kColsTile) * kColsStride;
      for (int r = 0; r < kColsRows; ++r) bsum += __bfloat162float(col[r]);
    }
#pragma unroll
    for (int ks = 0; ks < kColsRows; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* pr = pt + (wm + mt * 16 + g) * kColsStride + ks + t * 2;
        af[mt][0] = ld32(pr);
        af[mt][1] = ld32(pr + 8 * kColsStride);
        af[mt][2] = ld32(pr + 8);
        af[mt][3] = ld32(pr + 8 * kColsStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* qr = qt + (wn + nt * 8 + g) * kColsStride + ks + t * 2;
        const uint32_t b0 = ld32(qr), b1 = ld32(qr + 8);
        mma_bf16(acc[0][nt], af[0], b0, b1);
        mma_bf16(acc[1][nt], af[1], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int64_t ja = j0 + wm + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = c0 + wn + nt * 8 + t * 2;
      *reinterpret_cast<float2*>(dw + ja * c + col) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(dw + (ja + 8) * c + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  if (sum_p) dbp[j0 + threadIdx.x] = bsum;
  if (sum_q) dbq[c0 + threadIdx.x - kColsTile] = bsum;
}

// ---------------------------------------------------------------------------
// columns kernel, scalar
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
int launch_cols(bool mma, const void* p, const void* qm, float* dw, float* dbp, float* dbq,
                int rows, int hidden, int c, int is_bf16, cudaStream_t stream) {
  if (mma) {
    using B = __nv_bfloat16;
    mlp_cols_mma_kernel<kGelu><<<dim3(c / kColsTile, hidden / kColsTile), kMmaThreads, 0,
                                 stream>>>(static_cast<const B*>(p), static_cast<const B*>(qm),
                                           dw, dbp, dbq, rows, hidden, c);
  } else {
    const dim3 grid((c + kTile - 1) / kTile, (hidden + kTile - 1) / kTile);
    if (is_bf16) {
      using B = __nv_bfloat16;
      mlp_cols_kernel<B, kGelu><<<grid, kThreads, 0, stream>>>(
          static_cast<const B*>(p), static_cast<const B*>(qm), dw, dbp, dbq, rows, hidden, c);
    } else {
      mlp_cols_kernel<float, kGelu><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(p), static_cast<const float*>(qm), dw, dbp, dbq, rows,
          hidden, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a launch at these arguments takes the tensor-core kernels
extern "C" int mem_mlp_bwd_uses_mma(const void* dout, const void* h, const void* x,
                                    const void* w1, const void* w2, const void* dx,
                                    const void* dh_ws, int c, int hidden, int is_bf16) {
  const void* ptrs[7] = {dout, h, x, w1, w2, dx, dh_ws};
  return is_bf16 && mlp_mma_shape(c, hidden) && aligned16(ptrs, 7) ? 1 : 0;
}

// dout, x, dx: (rows, c); h, dh_ws (scratch): (rows, hidden); w1: (c, hidden);
// w2: (hidden, c); all in one dtype (bf16 or f32). dw1t, dw2: (hidden, c) f32;
// db1: (hidden) f32; db2: (c) f32.
extern "C" int mem_mlp_bwd(const void* dout, const void* h, const void* x, const void* w1,
                           const void* w2, void* dx, float* dw1t, float* dw2, float* db1,
                           float* db2, void* dh_ws, int rows, int c, int hidden, int is_bf16,
                           cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);   // the sums would be unset
  if ((hidden + kTile - 1) / kTile > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = mem_mlp_bwd_uses_mma(dout, h, x, w1, w2, dx, dh_ws, c, hidden, is_bf16);
  int rc = dispatch_rows<true>(mma, dout, w2, w1, nullptr, nullptr, h, dh_ws, dx, rows, c,
                               hidden, is_bf16, stream);
  if (rc != 0) return rc;
  rc = launch_cols<true>(mma, h, dout, dw2, nullptr, db2, rows, hidden, c, is_bf16, stream);
  if (rc != 0) return rc;
  return launch_cols<false>(mma, dh_ws, x, dw1t, db1, nullptr, rows, hidden, c, is_bf16, stream);
}
