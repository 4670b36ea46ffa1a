// The mma.sync one-hot contraction of the voxelizer experiment X2
// (exp_voxelize2.cu), which alone includes this file: the block's tile, the
// hit masks that make the fragments, the staging loop and the write-out, and
// the bf16 k-step of X2b.
//
// A block of 4 warps owns a 64-row x 128-column tile of one sample's
// (rows, 2W) plane as accumulators in registers: warp (wm, wn) holds rows
// wm * 32 + [0, 32) and columns wn * 64 + [0, 64), as 2 x 8 m16n8 tiles. A
// lane (g = lane / 4, t = lane % 4) holds rows row_base + 8 i (i < 4) and
// columns col_base + 8 nt (nt < 8) of its fragments, so which of them an
// event hits is a bit mask (hit): an event in a 32-row (64-column) warp slice
// on the lane's residue mod 8 sets one bit, any other event none. The staged
// events are read from shared memory, a k-step at a time, and each mask
// becomes fragment registers by two integer instructions.
//
// The including file defines the kernels and their entry points.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;       // 2 warps x 32 rows
constexpr int kTileCols = 128;      // 2 warps x 64 columns
constexpr uint32_t kOne = 0x3F80u;  // bf16 1.0 = 0x7F << 7

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bit (v - base) / 8 when v lies in [base, base + span) on base's residue
// mod 8, else 0: which of a thread's rows or columns (base + 8 i) v hits.
__device__ __forceinline__ uint32_t hit(int v, int base, int span) {
  const unsigned rel = static_cast<unsigned>(v) - static_cast<unsigned>(base);
  return (rel < static_cast<unsigned>(span) && (rel & 7u) == 0u) ? 1u << (rel >> 3) : 0u;
}

// Two events' hit masks (low and high 16 bits) -> the fragment register of
// bit i: bf16 1.0 in each half whose event hits
__device__ __forceinline__ uint32_t ones(uint32_t m, int i) {
  return (m & (0x10001u << i)) * (kOne >> i);
}

template <typename T>
__device__ __forceinline__ void zero_tile(T (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = T(0);
}

// Stage events [s0, s0 + len) of a and ys in shared memory, padded with -1
// (hits no row or column) to a multiple of the k-step kStep, between two
// barriers; extra(i, in) stages anything else event i carries. Returns the
// padded length.
template <int kStep, typename Extra>
__device__ __forceinline__ int stage_events(int32_t* sa, int32_t* sy, const int32_t* ga,
                                            const int32_t* gy, int s0, int len, Extra extra) {
  const int padded = (len + kStep - 1) & ~(kStep - 1);
  __syncthreads();   // the previous stage is consumed
  for (int i = threadIdx.x; i < padded; i += kThreads) {
    const bool in = i < len;
    sa[i] = in ? __ldg(ga + s0 + i) : -1;
    sy[i] = in ? __ldg(gy + s0 + i) : -1;
    extra(i, in);
  }
  __syncthreads();
  return padded;
}

// One 16-event k-step of onehot(ys)^T . onehot(col) from the staged
// (col, ys): bf16 mma.sync m16n8k16, f32 accumulate.
__device__ __forceinline__ void onehot_step_bf16(float (&acc)[2][8][4], const int32_t* sa,
                                                 const int32_t* sy, int k, int t, int row_base,
                                                 int col_base) {
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
  const uint32_t mc_lo = hit(clo.x, col_base, 64) | (hit(clo.y, col_base, 64) << 16);
  const uint32_t mc_hi = hit(chi.x, col_base, 64) | (hit(chi.y, col_base, 64) << 16);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const uint32_t b0 = ones(mc_lo, nt), b1 = ones(mc_hi, nt);
    mma_bf16(acc[0][nt], fa[0], b0, b1);
    mma_bf16(acc[1][nt], fa[1], b0, b1);
  }
}

// Write the tile once into a (rows, w2) plane: rows past `rows` and columns
// past w2 are not stored.
template <typename T>
__device__ __forceinline__ void store_tile(T* plane, const T (&acc)[2][8][4], int row_base,
                                           int col_base, int g, int t, int rows, int w2) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = row_base + mi * 16;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = col_base - g + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
        if (rr < rows && cc < w2) plane[static_cast<int64_t>(rr) * w2 + cc] = acc[mi][nt][e];
      }
    }
  }
}

}  // namespace
