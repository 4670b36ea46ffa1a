// X1a, X1b, X1c: the voxelizer experiment's one-hot contractions
// (scripts/exp_voxelize.py) on the H100's tensor cores.
//
// Replaces scripts/exp_voxelize.py:_kernel_base (X1a), _kernel_fused_onehot
// (X1b) and _kernel_fused_loop (X1c), three TPU formulations of the count
// planes that K1 (csrc/voxelize_hist.cu) computes with integer atomics:
// one-hot factors built in VMEM and contracted on the matrix unit,
//
//   out[b] (H, 2W) f32 = onehot(ys)^T (H x N) . onehot(col) (N x 2W)
//
// - X1b: col = x + W * (p < 0) packed by the caller (pack_cols), 2W or any
//   value outside [0, 2W) drops the event, as does ys outside [0, H): K1's
//   function, as f32.
// - X1a: the four raw arrays, no packing pass: column x takes bf16(wpos),
//   column W + x takes bf16(wneg) (the reference's rounding,
//   exp_voxelize.py:41-42); x outside [0, W) or y outside [0, H) adds nothing.
// - X1c: X1b's function, each chunk consumed `inner` events at a time.
//
// The experiment asks whether the matrix-unit formulation has a place on
// Hopper beside K1's atomics, so the variants keep it: every event enters
// every output tile of its sample as a one-hot column of a bf16
// mma.sync.m16n8k16 (f32 accumulate), the zeros included. What bounds that
// on the H100 is not the bytes (K1's bound) but building the fragments: at
// the seg shape (8 x 180,224 events, 440 x 1280 planes) the contraction is
// 8.3e11 multiply-adds, 1.7 ms at the bf16 peak, and every mma needs its B
// fragment made from the staged event indices by integer instructions.
//
// Design (the block, the staging and the write-out are exp_voxelize.cuh's,
// shared with X2; the k-step is written out in the kernel, which says why).
// One block of 4 warps owns a 64-row x 128-column tile of one sample's plane
// as f32 accumulators in registers (a warp: 32 rows x 64 columns, 2 x 8
// m16n8 tiles) and streams all of the sample's events through shared memory,
// `stage` events at a time. For each 16-event k-step a thread
// reads the 4 events its fragments cover and turns each into a bit mask of
// the row (or column) tiles it hits among the thread's own rows (columns),
// two events per 32-bit word; a masked bit times 0x3F80 >> bit is bf16 1.0 in
// its half of the fragment register, so a B fragment costs two integer
// instructions and serves both of the warp's m16 tiles. The tile is written
// once: the output needs no zero fill and no atomics.
//
// Numerics: the one-hot products are exact and the f32 sums of integer
// counts stay exact below 2^24 (a cell gets at most N = 180,224 events), so
// X1b and X1c equal K1's plain version bit for bit; X1a does as long as
// every partial sum of bf16 weights is representable (dyadic weights).
//
// The reference's `chunk` is the staging size of X1a and X1b; X1c stages
// `inner` events at a time, so its wrapper launches X1b's entry point with
// chunk = inner (after checking that inner divides chunk: the reference
// loops chunk // inner times and drops the tail of every chunk otherwise).
// `bgroup`, a TPU block constraint, has no counterpart. No chunk is skipped:
// skipping by row band is K4's and X2's.
//
// Allocates nothing and does not synchronise.

#include "exp_voxelize.cuh"

namespace {

// two events' hit masks -> a 0xFFFF mask per half, for X1a's weights
__device__ __forceinline__ uint32_t halves(uint32_t m, int i) {
  return ((m >> i) & 0x10001u) * 0xFFFFu;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&b));
}

// kRaw: X1a's four raw arrays (a = xs, b = ys, wpos, wneg); else X1b's packed
// (a = col, b = ys). Shared memory: stage events of a and of ys, and for X1a
// one word of bf16(wpos) | bf16(wneg) << 16 per event.
template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
onehot_planes_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ ys,
                     const float* __restrict__ wpos, const float* __restrict__ wneg,
                     float* __restrict__ out, int n, int h, int w, int stage) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* sa = smem;              // [stage] col (X1b) or x (X1a)
  int32_t* sy = sa + stage;        // [stage] y
  uint32_t* sw = reinterpret_cast<uint32_t*>(sy + stage);   // [stage] X1a weights

  const int w2 = 2 * w;
  const int64_t b = blockIdx.z;
  const int32_t* ga = a + b * n;
  const int32_t* gy = ys + b * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int row_base = blockIdx.y * kTileRows + wm * 32 + g;   // + 8 i, i < 4
  const int col_base = blockIdx.x * kTileCols + wn * 64 + g;   // + 8 nt, nt < 8

  float acc[2][8][4];
  zero_tile(acc);

  for (int s0 = 0; s0 < n; s0 += stage) {
    const int len = min(stage, n - s0);
    const int padded = stage_events<16>(sa, sy, ga, gy, s0, len, [&](int i, bool in) {
      if constexpr (kRaw) {
        sw[i] = in ? bf16_bits(__ldg(wpos + b * n + s0 + i)) |
                         (bf16_bits(__ldg(wneg + b * n + s0 + i)) << 16)
                   : 0u;
      }
    });

    // The k-step stays written out here rather than as exp_voxelize.cuh's
    // onehot_step_bf16 (X2b's copy of X1b's branch): every split of it into
    // a function that was tried moved X1b from 126 to 128 registers (ptxas,
    // sm_90a), and X1 keeps its parent's code.
    for (int k = 0; k < padded; k += 16) {
      // this thread's events: k + 2t, k + 2t + 1 (lo) and k + 2t + 8, k + 2t + 9 (hi)
      const int2 ylo = *reinterpret_cast<const int2*>(sy + k + 2 * t);
      const int2 yhi = *reinterpret_cast<const int2*>(sy + k + 2 * t + 8);
      const int2 clo = *reinterpret_cast<const int2*>(sa + k + 2 * t);
      const int2 chi = *reinterpret_cast<const int2*>(sa + k + 2 * t + 8);
      const uint32_t ry_lo = hit(ylo.x, row_base, 32) | (hit(ylo.y, row_base, 32) << 16);
      const uint32_t ry_hi = hit(yhi.x, row_base, 32) | (hit(yhi.y, row_base, 32) << 16);
      // A fragments of the two m16 tiles: rows g (bit 2 mi) and g + 8 (bit 2 mi + 1)
      uint32_t fa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        fa[mi][0] = ones(ry_lo, 2 * mi);
        fa[mi][1] = ones(ry_lo, 2 * mi + 1);
        fa[mi][2] = ones(ry_hi, 2 * mi);
        fa[mi][3] = ones(ry_hi, 2 * mi + 1);
      }
      if constexpr (kRaw) {
        // column x takes bf16(wpos), column W + x bf16(wneg); x outside [0, W) none
        const uint2 wlo = *reinterpret_cast<const uint2*>(sw + k + 2 * t);
        const uint2 whi = *reinterpret_cast<const uint2*>(sw + k + 2 * t + 8);
        const int xs[4] = {clo.x, clo.y, chi.x, chi.y};
        uint32_t hp[4], hn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = static_cast<unsigned>(xs[e]) < static_cast<unsigned>(w);
          hp[e] = ok ? hit(xs[e], col_base, 64) : 0u;
          hn[e] = ok ? hit(xs[e] + w, col_base, 64) : 0u;
        }
        const uint32_t mp_lo = hp[0] | (hp[1] << 16), mp_hi = hp[2] | (hp[3] << 16);
        const uint32_t mn_lo = hn[0] | (hn[1] << 16), mn_hi = hn[2] | (hn[3] << 16);
        const uint32_t wp_lo = (wlo.x & 0xFFFFu) | (wlo.y << 16);
        const uint32_t wn_lo = (wlo.x >> 16) | (wlo.y & 0xFFFF0000u);
        const uint32_t wp_hi = (whi.x & 0xFFFFu) | (whi.y << 16);
        const uint32_t wn_hi = (whi.x >> 16) | (whi.y & 0xFFFF0000u);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t b0 = (wp_lo & halves(mp_lo, nt)) | (wn_lo & halves(mn_lo, nt));
          const uint32_t b1 = (wp_hi & halves(mp_hi, nt)) | (wn_hi & halves(mn_hi, nt));
          mma_bf16(acc[0][nt], fa[0], b0, b1);
          mma_bf16(acc[1][nt], fa[1], b0, b1);
        }
      } else {
        const uint32_t mc_lo = hit(clo.x, col_base, 64) | (hit(clo.y, col_base, 64) << 16);
        const uint32_t mc_hi = hit(chi.x, col_base, 64) | (hit(chi.y, col_base, 64) << 16);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t b0 = ones(mc_lo, nt), b1 = ones(mc_hi, nt);
          mma_bf16(acc[0][nt], fa[0], b0, b1);
          mma_bf16(acc[1][nt], fa[1], b0, b1);
        }
      }
    }
  }

  store_tile(out + b * h * static_cast<int64_t>(w2), acc, row_base, col_base, g, t, h, w2);
}

template <bool kRaw>
int launch(const int32_t* a, const int32_t* ys, const float* wpos, const float* wneg,
           float* out, int b, int n, int h, int w, int stage, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || stage <= 0 || stage % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stage) * (kRaw ? 3 : 2) * sizeof(int32_t);
  static size_t opted = 48 * 1024;   // the attribute is per kernel: raise it as needed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        onehot_planes_kernel<kRaw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid((2 * w + kTileCols - 1) / kTileCols, (h + kTileRows - 1) / kTileRows, b);
  onehot_planes_kernel<kRaw><<<grid, kThreads, smem, stream>>>(a, ys, wpos, wneg, out, n, h, w,
                                                                stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X1a: xs, ys int32, wpos, wneg f32, all (b, n); out (b, h, 2w) f32.
extern "C" int mem_exp_voxelize_base(const int32_t* xs, const int32_t* ys, const float* wpos,
                                     const float* wneg, float* out, int b, int n, int h, int w,
                                     int chunk, cudaStream_t stream) {
  return launch<true>(xs, ys, wpos, wneg, out, b, n, h, w, chunk, stream);
}

// X1b: col, ys int32 (b, n); out (b, h, 2w) f32. X1c is this launch with
// chunk = inner.
extern "C" int mem_exp_voxelize_fused_onehot(const int32_t* col, const int32_t* ys, float* out,
                                             int b, int n, int h, int w, int chunk,
                                             cudaStream_t stream) {
  return launch<false>(col, ys, nullptr, nullptr, out, b, n, h, w, chunk, stream);
}
