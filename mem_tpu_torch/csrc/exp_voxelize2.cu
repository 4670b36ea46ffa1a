// X2a, X2b, X2c: the voxelizer's second round of experiments
// (scripts/exp_voxelize2.py) on the H100's tensor cores.
//
// Replaces scripts/exp_voxelize2.py:_kernel_fused_i8 (X2a), _kernel_tiled
// (X2b) and _kernel_tiled_i8 (X2c): two cuts of X1b's one-hot contraction
// (exp_voxelize.cu) of the count planes,
//
//   out[b] (rows, 2W) = onehot(ys)^T (rows x N) . onehot(col) (N x 2W)
//
// - X2a: X1b's dense contraction with int8 one-hots and int32 sums: rows =
//   H, out int32; K1's function (ys outside [0, H) and col outside [0, 2W)
//   add nothing).
// - X2b: a row-band accumulator on y-sorted events that skips every (band,
//   chunk) pair the chunk's y range misses: rows = n_tiles * TH (n_tiles =
//   ceil(H / TH)), bf16 one-hots, f32 sums. Rows H <= y < n_tiles * TH are
//   part of the function, as in the pallas_call's output: an event there
//   counts there (the caller crops [:, :H]).
// - X2c: X2b with int8 one-hots and int32 sums.
//
// The reference's skip test, per band t of TH rows and per chunk of `chunk`
// events, is kept as it is: the band computes the chunk only when
// max(ys) >= t * TH and min(ys) < (t + 1) * TH over the chunk's events,
// invalid ones included. It is exact for any event order (a chunk it skips
// has no y in the band); y-sorted events only make it skip more. A tighter
// per-block test would also be exact but would change what the experiment
// measures (a later idea).
//
// Design (the block, the staging and the write-out are exp_voxelize.cuh's):
// one block of 4 warps owns a 64-row x 128-column tile of one sample's
// plane in registers and streams events through shared memory a chunk at a
// time.
// - int8 (X2a, X2c): mma.sync.m16n8k32.s32.s8.s8.s32. A thread's A and B
//   registers hold four int8 one-hots each; by the PTX fragment layout it
//   covers events 4t..4t+3 (lo) and 4t+16..4t+19 (hi) of each 32-event
//   k-step. Each event's hit mask (4 row bits, 8 column bits) goes into one
//   byte of a word, and (mask >> i) & 0x01010101 is the register of bit i:
//   int8 1 in each byte whose event hits. A 32-event k-step is 16 mma per
//   warp, as the bf16 16-event one is, with 16 hit masks instead of 8.
// - bf16 (X2b): exp_voxelize.cuh's k-step (onehot_step_bf16).
// - The tiled kernels (X2b, X2c) are two kernels in one launch, as K4's
//   (voxelize_hist_sorted.cu): (a) chunk_minmax_kernel writes min and max
//   of ys over every chunk of every sample into a (B, n_chunks, 2) int32
//   scratch the wrapper allocates; (b) the tile kernel walks that table.
//   A 32-row warp slice lies in one band (TH is a multiple of 32), so each
//   warp applies its own band's test; the block stages a chunk when either
//   warp row needs it. TH = 32 gives a block two bands, TH = 64 one, and
//   TH = 128 spreads one band over two blocks that make the same test.
// - The ragged last chunk is masked in the kernel (the wrapper pads
//   nothing): without the reference's sentinel padding its max is lower,
//   which skips more and changes no count.
// - Every output element is written once, by one thread: no zero fill and
//   no atomics.
//
// What bounds it on the H100: the integer instructions that build the
// fragments (X1b ran a quarter of the bf16 peak on this block), not the
// bytes (29.9 MB at the seg shape, 0.009 ms) nor the products (1.6e12 one-hot
// multiply-adds, 0.82 ms at the int8 peak). int8 halves the mma count and
// builds the fragments of 32 events with about 1.5 times the instructions of
// bf16's 16; the band skip cuts the events a warp consumes to the chunks that
// meet its band (at 440 rows and ~410 sorted events per row per sample, a
// 64-row band meets ~14 of the 88 chunks of 2048).
//
// Numerics: one-hot products are exact, int32 sums exact, f32 sums of counts
// exact below 2^24: every variant equals its plain version bit for bit.
//
// Allocates nothing and does not synchronise.

#include <climits>

#include "exp_voxelize.cuh"

namespace {

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four events' hit masks, one per byte
__device__ __forceinline__ uint32_t hits4(int4 v, int base, int span) {
  return hit(v.x, base, span) | (hit(v.y, base, span) << 8) | (hit(v.z, base, span) << 16) |
         (hit(v.w, base, span) << 24);
}

// Four events' hit masks -> the fragment register of bit i: int8 1 in each
// byte whose event hits
__device__ __forceinline__ uint32_t bytes(uint32_t m, int i) { return (m >> i) & 0x01010101u; }

// One 32-event k-step of onehot(ys)^T . onehot(col) from the staged
// (col, ys): int8 mma.sync m16n8k32, int32 accumulate.
__device__ __forceinline__ void onehot_step_s8(int32_t (&acc)[2][8][4], const int32_t* sc,
                                               const int32_t* sy, int k, int t, int row_base,
                                               int col_base) {
  const int4 ylo = *reinterpret_cast<const int4*>(sy + k + 4 * t);
  const int4 yhi = *reinterpret_cast<const int4*>(sy + k + 4 * t + 16);
  const int4 clo = *reinterpret_cast<const int4*>(sc + k + 4 * t);
  const int4 chi = *reinterpret_cast<const int4*>(sc + k + 4 * t + 16);
  const uint32_t ry_lo = hits4(ylo, row_base, 32), ry_hi = hits4(yhi, row_base, 32);
  // A fragments of the two m16 tiles: rows g (bit 2 mi) and g + 8 (bit 2 mi + 1)
  uint32_t fa[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    fa[mi][0] = bytes(ry_lo, 2 * mi);
    fa[mi][1] = bytes(ry_lo, 2 * mi + 1);
    fa[mi][2] = bytes(ry_hi, 2 * mi);
    fa[mi][3] = bytes(ry_hi, 2 * mi + 1);
  }
  const uint32_t mc_lo = hits4(clo, col_base, 64), mc_hi = hits4(chi, col_base, 64);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const uint32_t b0 = bytes(mc_lo, nt), b1 = bytes(mc_hi, nt);
    mma_s8(acc[0][nt], fa[0], b0, b1);
    mma_s8(acc[1][nt], fa[1], b0, b1);
  }
}

struct StepBf16 {   // X2b
  using Acc = float;
  static constexpr int kStep = 16;
  __device__ static __forceinline__ void step(float (&acc)[2][8][4], const int32_t* sc,
                                              const int32_t* sy, int k, int t, int row_base,
                                              int col_base) {
    onehot_step_bf16(acc, sc, sy, k, t, row_base, col_base);
  }
};

struct StepS8 {     // X2a, X2c
  using Acc = int32_t;
  static constexpr int kStep = 32;
  __device__ static __forceinline__ void step(int32_t (&acc)[2][8][4], const int32_t* sc,
                                              const int32_t* sy, int k, int t, int row_base,
                                              int col_base) {
    onehot_step_s8(acc, sc, sy, k, t, row_base, col_base);
  }
};

// min and max of ys over every chunk of every sample, invalid events
// included; one block per (chunk, sample)
__global__ void __launch_bounds__(256)
chunk_minmax_kernel(const int32_t* __restrict__ ys, int2* __restrict__ bounds, int n,
                    int chunk, int n_chunks) {
  const int64_t b = blockIdx.y;
  const int c = blockIdx.x;
  const int32_t* y = ys + b * n;
  int lo = INT_MAX, hi = INT_MIN;
  const int start = c * chunk;
  const int end = start + min(chunk, n - start);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int yi = __ldg(y + i);
    lo = min(lo, yi);
    hi = max(hi, yi);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ int slo[8], shi[8];
  if (threadIdx.x % 32 == 0) {
    slo[threadIdx.x / 32] = lo;
    shi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) {
      lo = min(lo, slo[w]);
      hi = max(hi, shi[w]);
    }
    bounds[b * n_chunks + c] = make_int2(lo, hi);
  }
}

// The reference's test for the band of TH rows that holds the 32 warp rows
// from r0: max(ys) >= band * TH and min(ys) < (band + 1) * TH; no band past
// the output's rows.
__device__ __forceinline__ bool band_meets(int2 lh, int r0, int th, int rows) {
  const int band_lo = r0 / th * th;
  return r0 < rows && lh.y >= band_lo && lh.x < band_lo + th;
}

// kTiled: X2b / X2c on the (B, n_chunks) bounds table, rows = n_tiles * TH;
// else X2a, rows = H, every chunk consumed. Shared memory: chunk events of
// col and of ys.
template <typename Step, bool kTiled>
__global__ void __launch_bounds__(kThreads)
x2_planes_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ ys,
                 const int2* __restrict__ bounds, typename Step::Acc* __restrict__ out, int n,
                 int rows, int w, int chunk, int th) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* sc = smem;              // [chunk] col
  int32_t* sy = sc + chunk;        // [chunk] y

  const int w2 = 2 * w;
  const int64_t b = blockIdx.z;
  const int32_t* gc = col + b * n;
  const int32_t* gy = ys + b * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int row_base = blockIdx.y * kTileRows + wm * 32 + g;   // + 8 i, i < 4
  const int col_base = blockIdx.x * kTileCols + wn * 64 + g;   // + 8 nt, nt < 8

  typename Step::Acc acc[2][8][4];
  zero_tile(acc);

  const int n_chunks = n / chunk + (n % chunk != 0);
  bool mine = true;   // this warp consumes the staged chunk
  for (int c = 0; c < n_chunks; ++c) {
    if constexpr (kTiled) {
      const int2 lh = bounds[b * n_chunks + c];   // one entry for the whole block
      const int r0 = blockIdx.y * kTileRows;
      const bool m0 = band_meets(lh, r0, th, rows), m1 = band_meets(lh, r0 + 32, th, rows);
      if (!(m0 || m1)) continue;   // block-uniform
      mine = wm == 0 ? m0 : m1;
    }
    const int s0 = c * chunk;
    const int padded = stage_events<Step::kStep>(sc, sy, gc, gy, s0, min(chunk, n - s0),
                                                 [](int, bool) {});
    if (mine) {
      for (int k = 0; k < padded; k += Step::kStep) {
        Step::step(acc, sc, sy, k, t, row_base, col_base);
      }
    }
  }

  store_tile(out + b * rows * static_cast<int64_t>(w2), acc, row_base, col_base, g, t, rows, w2);
}

template <typename Step, bool kTiled>
int launch(const int32_t* col, const int32_t* ys, typename Step::Acc* out, int2* bounds, int b,
           int n, int h, int w, int th, int chunk, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || chunk <= 0 || chunk % Step::kStep != 0 ||
      (kTiled && (th <= 0 || th % 32 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kTiled ? (h + th - 1) / th * th : h;
  const int n_chunks = n / chunk + (n % chunk != 0);
  if (kTiled && n_chunks > 0) {
    chunk_minmax_kernel<<<dim3(n_chunks, b), 256, 0, stream>>>(ys, bounds, n, chunk, n_chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = static_cast<size_t>(chunk) * 2 * sizeof(int32_t);
  static size_t opted = 48 * 1024;   // the attribute is per kernel: raise it as needed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        x2_planes_kernel<Step, kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid((2 * w + kTileCols - 1) / kTileCols, (rows + kTileRows - 1) / kTileRows, b);
  x2_planes_kernel<Step, kTiled><<<grid, kThreads, smem, stream>>>(col, ys, bounds, out, n, rows,
                                                                    w, chunk, th);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X2a: col, ys int32 (b, n); out (b, h, 2w) int32; chunk a multiple of 32.
extern "C" int mem_exp_voxelize2_fused_i8(const int32_t* col, const int32_t* ys, int32_t* out,
                                          int b, int n, int h, int w, int chunk,
                                          cudaStream_t stream) {
  return launch<StepS8, false>(col, ys, out, nullptr, b, n, h, w, 0, chunk, stream);
}

// X2b: col, ys int32 (b, n); out (b, ceil(h / th) * th, 2w) f32; bounds an
// int32 (b, ceil(n / chunk), 2) scratch; th a multiple of 32, chunk of 16.
extern "C" int mem_exp_voxelize2_tiled(const int32_t* col, const int32_t* ys, float* out,
                                       void* bounds, int b, int n, int h, int w, int th,
                                       int chunk, cudaStream_t stream) {
  return launch<StepBf16, true>(col, ys, out, static_cast<int2*>(bounds), b, n, h, w, th, chunk,
                                stream);
}

// X2c: X2b's arguments, out int32; chunk a multiple of 32.
extern "C" int mem_exp_voxelize2_tiled_i8(const int32_t* col, const int32_t* ys, int32_t* out,
                                          void* bounds, int b, int n, int h, int w, int th,
                                          int chunk, cudaStream_t stream) {
  return launch<StepS8, true>(col, ys, out, static_cast<int2*>(bounds), b, n, h, w, th, chunk,
                              stream);
}
