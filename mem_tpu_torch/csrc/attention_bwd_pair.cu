// X3: K2b's function with each head's two depth-64 products of phase 1,
// s = q k^T and dp = do v^T, taken as ONE depth-128 product
//
//   [q | do] (N x 2D) . [[k^T, 0], [0, v^T]] (2D x 2N) = [q k^T | do v^T]
//
// Replaces scripts/exp_attn_bwd.py:_bwd_flat_pair_kernel, the experiment
// that asks whether K2b (mem_tpu/ops/attention.py:_bwd_flat_kernel) gains by
// feeding the TPU's 128-deep matrix unit one full-depth product instead of
// two half-depth ones. On Hopper a k16 step costs the same whatever the
// product's depth, so the question becomes what the zero blocks cost: the
// pair executes 7 N^2 D multiply-adds per (b, h) where K2b's algorithm needs
// 5 (K2b itself executes 6: it recomputes dp, below).
//
// The arithmetic is K2b's (attention_bwd.cuh, which this file includes for
// the helpers, the tiling constants and the batch-order db sum); only phase
// 1's products differ:
// - The block-diagonal right operand is built in shared memory as the TPU
//   builds it in VMEM, zero blocks included: rows j < NT*8 of `bd` hold
//   [k_j | 0], rows NT*8 + j hold [0 | v_j] (zeros past n). Keys are padded to
//   the tile (NT*8 = 208 at N = 197) so that s and dp of one key land in the
//   same lane of their two output tiles.
// - A warp's 16 query rows keep [q | do] as 8 A fragments; each output tile
//   of the product runs all 8 k16 steps, in order: the s tiles add do . 0
//   after q k^T, the dp tiles start with q . 0. Adding exact zeros to f32
//   sums changes no bit, so with K2b's step order the pair's dq, dk, dv and
//   db are bit-equal to K2b's.
// - Each output tile is computed once. K2b cannot also hold dp beside the
//   probabilities (255 registers at NT = 26) and computes it twice (delta,
//   then ds); the pair parks its dp tile in the ds workspace row that ds
//   overwrites a moment later (the same thread reads it back), so the
//   product's dp half is the reference's `both[:, N:]`, made once.
// - Shared memory: bd is 2 NT*8 x 136 bf16 (113 KB at N = 197) plus K^T
//   for dq; phase 2 (dk, dv: K2b's code) restages Q^T and dO^T over bd.
//   140.8 KB at N = 197, 173 KB at N = 256.
// bf16, D = 64 and N <= 256 only (the wrapper raises for anything else).
// Allocates nothing and does not synchronise.

#include "attention_bwd.cuh"

namespace {

constexpr int kPairStride = 2 * kMmaD + 8;   // bd rows: 68 words -> 8 rows x 4 lanes on 32 banks

size_t pair_smem_bytes(int nt) {
  const size_t bd = 2 * static_cast<size_t>(nt) * 8 * kPairStride * 2;
  const size_t qd = 2 * static_cast<size_t>(kMmaD) * t_stride(nt) * 2;   // phase 2, over bd
  return (bd > qd ? bd : qd) + static_cast<size_t>(kMmaD) * t_stride(nt) * 2;
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_pair_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv,
                              float* ds_ws, __nv_bfloat16* pc_ws,
                              int n, int heads, float scale) {
  constexpr int kKeys = NT * 8;
  constexpr int kTs = t_stride(NT);
  constexpr size_t kBdElems = 2 * static_cast<size_t>(kKeys) * kPairStride;
  constexpr size_t kQdElems = 2 * static_cast<size_t>(kMmaD) * kTs;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bd = reinterpret_cast<__nv_bfloat16*>(smem);      // [2 kKeys][kPairStride]
  __nv_bfloat16* kt = bd + (kBdElems > kQdElems ? kBdElems : kQdElems);   // [64][kTs]
  __nv_bfloat16* qt = bd;                                          // phase 2: [64][kTs]
  __nv_bfloat16* dot = bd + kMmaD * kTs;                           // phase 2: [64][kTs]

  const int h = blockIdx.x;
  const int c = layout_row_stride(heads, kMmaD);
  const int64_t base = layout_base(blockIdx.y, h, n, heads, kMmaD, c);
  const int64_t wbase = (static_cast<int64_t>(blockIdx.y) * heads + h) * n * n;

  // stage the block-diagonal operand and K^T, 16 B per load, zeros past n
  for (int idx = threadIdx.x; idx < kKeys * (kMmaD / 8); idx += kMmaThreads) {
    const int j = idx / (kMmaD / 8);
    const int seg = (idx % (kMmaD / 8)) * 8;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 kv = zero, vv = zero;
    if (j < n) {
      const int64_t g = base + static_cast<int64_t>(j) * c + seg;
      kv = *reinterpret_cast<const uint4*>(k + g);
      vv = *reinterpret_cast<const uint4*>(v + g);
    }
    *reinterpret_cast<uint4*>(bd + j * kPairStride + seg) = kv;
    *reinterpret_cast<uint4*>(bd + j * kPairStride + kMmaD + seg) = zero;
    *reinterpret_cast<uint4*>(bd + (kKeys + j) * kPairStride + seg) = zero;
    *reinterpret_cast<uint4*>(bd + (kKeys + j) * kPairStride + kMmaD + seg) = vv;
    const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
    for (int e = 0; e < 8; ++e) kt[(seg + e) * kTs + j] = ke[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int tiles = (n + 15) / 16;

  // -- phase 1: one 16-row query tile per warp at a time --------------------
  for (int rt = warp; rt < tiles; rt += kMmaWarps) {
    const int ra = rt * 16 + g, rb = ra + 8;
    const bool va = ra < n, vb = rb < n;
    uint32_t fa[2][kMmaD / 16][4];   // [q | do]: k16 steps 0-3 from q, 4-7 from do
    load_rows(fa[0], q, base, c, ra, rb, va, vb, t);
    load_rows(fa[1], dout, base, c, ra, rb, va, vb, t);

    // the product's s tiles (columns 0 .. kKeys), * scale + bias, keys >= n masked
    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      const __nv_bfloat16* br = bd + (nt * 8 + g) * kPairStride + t * 2;
#pragma unroll
      for (int s = 0; s < 2 * kMmaD / 16; ++s) {
        mma_bf16(p[nt], fa[s / 4][s % 4], ld32(br + s * 16), ld32(br + s * 16 + 8));
      }
    }
    const float* ba = bias + (static_cast<int64_t>(h) * n + (va ? ra : n - 1)) * n;
    const float* bb = bias + (static_cast<int64_t>(h) * n + (vb ? rb : n - 1)) * n;
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = nt * 8 + t * 2 + e;
        if (key < n) {
          p[nt][e] = __fadd_rn(__fmul_rn(p[nt][e], scale), ba[key]);
          p[nt][2 + e] = __fadd_rn(__fmul_rn(p[nt][2 + e], scale), bb[key]);
        } else {
          p[nt][e] = p[nt][2 + e] = -INFINITY;
        }
        mxa = fmaxf(mxa, p[nt][e]);
        mxb = fmaxf(mxb, p[nt][2 + e]);
      }
    }
    mxa = quad_max(mxa);
    mxb = quad_max(mxb);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = expf(p[nt][e] - mxa);
        p[nt][2 + e] = expf(p[nt][2 + e] - mxb);
        suma += p[nt][e];
        sumb += p[nt][2 + e];
      }
    }
    suma = quad_sum(suma);
    sumb = quad_sum(sumb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      p[nt][0] = __fdiv_rn(p[nt][0], suma);
      p[nt][1] = __fdiv_rn(p[nt][1], suma);
      p[nt][2] = __fdiv_rn(p[nt][2], sumb);
      p[nt][3] = __fdiv_rn(p[nt][3], sumb);
    }

    // the product's dp tiles (columns kKeys .. 2 kKeys): delta = rowsum(dp * p),
    // each tile parked in the ds workspace until ds replaces it
    float* dsa = ds_ws + wbase + static_cast<int64_t>(va ? ra : 0) * n;
    float* dsb = ds_ws + wbase + static_cast<int64_t>(vb ? rb : 0) * n;
    float dla = 0.f, dlb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* br = bd + (kKeys + nt * 8 + g) * kPairStride + t * 2;
#pragma unroll
      for (int s = 0; s < 2 * kMmaD / 16; ++s) {
        mma_bf16(dp, fa[s / 4][s % 4], ld32(br + s * 16), ld32(br + s * 16 + 8));
      }
      dla += dp[0] * p[nt][0] + dp[1] * p[nt][1];
      dlb += dp[2] * p[nt][2] + dp[3] * p[nt][3];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = nt * 8 + t * 2 + e;
        if (key < n) {
          if (va) dsa[key] = dp[e];
          if (vb) dsb[key] = dp[2 + e];
        }
      }
    }
    dla = quad_sum(dla);
    dlb = quad_sum(dlb);

    // ds = p (dp - delta): to the workspace with bf16(p), and bf16(ds)
    // straight into the A fragments of dq = ds k, 16 keys per step (K2b's)
    float acc[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    __nv_bfloat16* pca = pc_ws + wbase + static_cast<int64_t>(va ? ra : 0) * n;
    __nv_bfloat16* pcb = pc_ws + wbase + static_cast<int64_t>(vb ? rb : 0) * n;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = nt * 8 + t * 2 + e;
          // a padded key's or row's dp is the product's exact zero
          const float dpa = key < n && va ? dsa[key] : 0.f;
          const float dpb = key < n && vb ? dsb[key] : 0.f;
          ds[half][e] = __fmul_rn(p[nt][e], __fsub_rn(dpa, dla));
          ds[half][2 + e] = __fmul_rn(p[nt][2 + e], __fsub_rn(dpb, dlb));
          if (key < n) {
            if (va) {
              dsa[key] = ds[half][e];
              pca[key] = __float2bfloat16_rn(p[nt][e]);
            }
            if (vb) {
              dsb[key] = ds[half][2 + e];
              pcb[key] = __float2bfloat16_rn(p[nt][2 + e]);
            }
          }
        }
      }
      const uint32_t a[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      const __nv_bfloat16* kr = kt + g * kTs + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(acc[dn], a, ld32(kr + dn * 8 * kTs), ld32(kr + dn * 8 * kTs + 8));
      }
    }
    __nv_bfloat16* oa = dq + base + static_cast<int64_t>(ra) * c + t * 2;
    __nv_bfloat16* ob = dq + base + static_cast<int64_t>(rb) * c + t * 2;
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      if (va) {
        *reinterpret_cast<uint32_t*>(oa + dn * 8) =
            pack_bf16(__fmul_rn(acc[dn][0], scale), __fmul_rn(acc[dn][1], scale));
      }
      if (vb) {
        *reinterpret_cast<uint32_t*>(ob + dn * 8) =
            pack_bf16(__fmul_rn(acc[dn][2], scale), __fmul_rn(acc[dn][3], scale));
      }
    }
  }
  __syncthreads();   // bd is no longer read; the block's workspace rows are visible

  // restage Q^T and dO^T over bd for phase 2
  for (int idx = threadIdx.x; idx < kKeys * (kMmaD / 8); idx += kMmaThreads) {
    const int j = idx / (kMmaD / 8);
    const int seg = (idx % (kMmaD / 8)) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), dv4 = qv;
    if (j < n) {
      const int64_t gi = base + static_cast<int64_t>(j) * c + seg;
      qv = *reinterpret_cast<const uint4*>(q + gi);
      dv4 = *reinterpret_cast<const uint4*>(dout + gi);
    }
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qt[(seg + e) * kTs + j] = qe[e];
      dot[(seg + e) * kTs + j] = de[e];
    }
  }
  __syncthreads();

  // -- phase 2: K2b's, one 16-key tile per warp at a time: dv = p^T do, dk = ds^T q
  for (int ct = warp; ct < tiles; ct += kMmaWarps) {
    const int ja = ct * 16 + g, jb = ja + 8;
    const bool ka = ja < n, kb = jb < n;
    float accv[kMmaD / 8][4], acck[kMmaD / 8][4];
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      accv[dn][0] = accv[dn][1] = accv[dn][2] = accv[dn][3] = 0.f;
      acck[dn][0] = acck[dn][1] = acck[dn][2] = acck[dn][3] = 0.f;
    }
    for (int kk = 0; kk < NT / 2; ++kk) {
      const int i = kk * 16 + t * 2;
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = i + (r >> 1) * 8;
        const int kj = (r & 1) ? jb : ja;
        const bool kv = (r & 1) ? kb : ka;
        uint32_t plo = 0u, phi = 0u;
        float slo = 0.f, shi = 0.f;
        if (kv && qi < n) {
          plo = bits(pc_ws[wbase + static_cast<int64_t>(qi) * n + kj]);
          slo = ds_ws[wbase + static_cast<int64_t>(qi) * n + kj];
        }
        if (kv && qi + 1 < n) {
          phi = bits(pc_ws[wbase + static_cast<int64_t>(qi + 1) * n + kj]);
          shi = ds_ws[wbase + static_cast<int64_t>(qi + 1) * n + kj];
        }
        pa[r] = plo | (phi << 16);
        sa[r] = pack_bf16(slo, shi);
      }
      const __nv_bfloat16* dr = dot + g * kTs + kk * 16 + t * 2;
      const __nv_bfloat16* qr = qt + g * kTs + kk * 16 + t * 2;
#pragma unroll
      for (int dn = 0; dn < kMmaD / 8; ++dn) {
        mma_bf16(accv[dn], pa, ld32(dr + dn * 8 * kTs), ld32(dr + dn * 8 * kTs + 8));
        mma_bf16(acck[dn], sa, ld32(qr + dn * 8 * kTs), ld32(qr + dn * 8 * kTs + 8));
      }
    }
    const int64_t oa = base + static_cast<int64_t>(ja) * c + t * 2;
    const int64_t ob = base + static_cast<int64_t>(jb) * c + t * 2;
#pragma unroll
    for (int dn = 0; dn < kMmaD / 8; ++dn) {
      if (ka) {
        *reinterpret_cast<uint32_t*>(dv + oa + dn * 8) = pack_bf16(accv[dn][0], accv[dn][1]);
        *reinterpret_cast<uint32_t*>(dk + oa + dn * 8) =
            pack_bf16(__fmul_rn(acck[dn][0], scale), __fmul_rn(acck[dn][1], scale));
      }
      if (kb) {
        *reinterpret_cast<uint32_t*>(dv + ob + dn * 8) = pack_bf16(accv[dn][2], accv[dn][3]);
        *reinterpret_cast<uint32_t*>(dk + ob + dn * 8) =
            pack_bf16(__fmul_rn(acck[dn][2], scale), __fmul_rn(acck[dn][3], scale));
      }
    }
  }
}

template <int NT>
int launch_pair(const void* q, const void* k, const void* v, const float* bias,
                const void* dout, void* dq, void* dk, void* dv, float* ds_ws, void* pc_ws,
                int b, int n, int heads, float scale, cudaStream_t stream) {
  const size_t smem = pair_smem_bytes(NT);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_pair_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  attention_bwd_pair_mma_kernel<NT><<<dim3(heads, b), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), ds_ws, static_cast<__nv_bfloat16*>(pc_ws), n, heads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (b, n, heads*64) bf16; bias, db: (heads, n, n)
// f32; ds_ws: (b, heads, n, n) f32 and pc_ws: (b, heads, n, n) bf16, both
// scratch. bf16, d = 64, n <= 256 and 16-byte aligned operands only: any
// other launch returns cudaErrorInvalidValue and runs nothing.
extern "C" int mem_attention_bwd_pair(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout, void* dq, void* dk,
                                      void* dv, float* db, float* ds_ws, void* pc_ws, int b,
                                      int n, int heads, int d, float scale, int is_bf16,
                                      cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (b > 65535 || !use_mma(ptrs, 7, n, d, is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc;
  switch (mma_tiles(n)) {
    case 8: rc = launch_pair<8>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
    case 16: rc = launch_pair<16>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
    case 26: rc = launch_pair<26>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
    default: rc = launch_pair<32>(q, k, v, bias, dout, dq, dk, dv, ds_ws, pc_ws, b, n, heads, scale, stream); break;
  }
  if (rc != 0) return rc;
  const int64_t hnn = static_cast<int64_t>(heads) * n * n;
  const int64_t blocks = (hnn + 255) / 256;
  attention_bwd_bias_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                                  stream>>>(ds_ws, db, hnn, b);
  return static_cast<int>(cudaGetLastError());
}
