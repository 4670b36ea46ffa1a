// The histogram body of K1 (voxelize_hist.cu) and K4 (voxelize_hist_sorted.cu):
// exact int32 event counts
//
//   out[b, ys[b, i], col[b, i]] += 1   for every event i with
//                                      0 <= col < 2W and 0 <= ys < H
//
// in any event order, counted on chip and written once. col = x + W * (p < 0)
// (2W marks an invalid event), ys = y (H marks one): the sentinels of
// voxelize_pallas.pack_cols. Negative values and values past the sentinels
// are dropped as well.
//
// The TPU kernels (voxelize_pallas.py _dense_kernel, _tiled_kernel) contract
// one-hot factors on the matrix unit because that chip has no fast scatter.
// Hopper has integer atomics in shared memory, so here a histogram is a
// scatter into shared memory. One sample's plane does not fit one block (512
// KB at 256x256, 2.25 MB at DSEC's 440x640; a block holds at most 227 KB), so
// a block owns a band of `rows` rows of one sample. It reads the events of
// its sample (K1: all of them, again for every band, from L2 after the first
// band; K4: the chunks of kChunk events from the first to the last whose
// [min y, max y] in the bounds table meets its band) and adds the events of
// its rows with shared-memory atomics. (Thread-block clusters that add into
// each other's shared memory, so that each event is read once, were slower
// at every shape measured: PERF.md section 6.)
//
// Then each block writes its rows once from shared memory with 16-byte
// stores, in one of two layouts:
//
// - planes: the (B, H, 2W) int32 counts [pos | neg] (the port of K1 / K4);
// - raster: the (B, H, W, 3) uint8 image of voxelize_fused without a time
//   surface: channel 0 the positive count, channel 1 zero, channel 2 the
//   negative count, each mod 256 (wrap) or min(count, 255) (clamp). This is
//   the tail XLA fuses after the Pallas call in the reference.
//
// Counters: 16 bits (two to a word) when the wrapper has proved N < 65,536
// for the launch (no cell can then reach 65,536), else 32 bits. A block has
// 1024 threads (64 registers each: one block an SM), so its band's events
// are read with many loads in flight, 16 bytes a load where a sample's row
// is aligned (a scalar head and tail otherwise: a sample starts at b * N * 4
// bytes). The grid is persistent: the wrapper's plan sizes it to the card
// (every block resident at once) and each block walks the (sample, band)
// items. No atomic reaches
// device memory, the output is never zero-filled, and a band no event touches
// is written as zeros. Allocates nothing and does not synchronise.
//
// What bounds it on the H100: bytes. The events are read once from device
// memory (K1's later bands read them from L2) and the
// output written once; the counting is one shared-memory atomic per event.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// Internal linkage: each file that includes this gets its own kernels.
namespace mem_hist {
namespace {

constexpr int kThreads = 1024;       // one block an SM: 64 registers a thread
constexpr int kChunk = 2048;         // events per bounds entry (K4's skip)
constexpr int kMaxSmem = 232448;     // dynamic shared memory one block may use
constexpr int kNarrowMaxN = 65535;   // 16-bit counters: every count stays below 65,536

enum Mode { kPlanes = 0, kRasterWrap = 1, kRasterClamp = 2 };

constexpr int kHeader = 16;          // shared memory ahead of the counters: the chunk range

// Dynamic shared memory of one block: the chunk range K4's skip shares, then
// its band of `rows` rows of 2W counters.
inline size_t band_smem(int rows, int w, bool wide) {
  return kHeader + static_cast<size_t>(rows) * 2 * w * (wide ? 4 : 2);
}

struct Band {
  unsigned base;    // shared-memory address of this block's counters
  int row0;         // first row of the band
  unsigned rows;    // rows of the band (cut at H)
  unsigned w2;      // 2W
};

// One event: its counter is cell (row - row0) * 2W + col of this block's band.
template <bool kWide>
__device__ __forceinline__ void count_event(const Band& bd, int c, int y) {
  const unsigned r = static_cast<unsigned>(y) - static_cast<unsigned>(bd.row0);
  const unsigned ci = static_cast<unsigned>(c);
  // unsigned compares drop negatives, the sentinels and the other bands
  if (r >= bd.rows || ci >= bd.w2) return;
  const unsigned cell = r * bd.w2 + ci;
  const unsigned addr = bd.base + 4u * (kWide ? cell : cell >> 1);
  const unsigned inc = kWide ? 1u : 1u << ((cell & 1u) << 4);
  // no "memory" clobber: the counters are read only after a barrier, which
  // has one, so the next events' loads may be issued ahead of these adds
  asm volatile("red.shared.add.u32 [%0], %1;" :: "r"(addr), "r"(inc));
}

template <bool kWide>
__device__ __forceinline__ void count4(const Band& bd, int4 c, int4 y) {
  count_event<kWide>(bd, c.x, y.x);
  count_event<kWide>(bd, c.y, y.y);
  count_event<kWide>(bd, c.z, y.z);
  count_event<kWide>(bd, c.w, y.w);
}

// [a, e): lo rounded up and hi rounded down to multiples of 4 (a <= e)
__device__ __forceinline__ void aligned_part(int64_t lo, int64_t hi, int64_t& a, int64_t& e) {
  a = (lo + 3) & ~int64_t(3);
  if (a > hi) a = hi;
  e = hi & ~int64_t(3);
  if (e < a) e = a;
}

// The events [lo, hi) of the flat (B * N) arrays: 16-byte loads from the
// first multiple of 4 on, a scalar head and tail of at most 3 events each.
template <bool kWide>
__device__ __forceinline__ void count_range(const int32_t* __restrict__ col,
                                            const int32_t* __restrict__ ys,
                                            int64_t lo, int64_t hi, const Band& bd) {
  int64_t a, e;
  aligned_part(lo, hi, a, e);
  const int t = threadIdx.x;
  const int head = static_cast<int>(a - lo), tail = static_cast<int>(hi - e);
  if (t < head) {
    count_event<kWide>(bd, __ldg(col + lo + t), __ldg(ys + lo + t));
  } else if (t < head + tail) {
    const int64_t i = e + (t - head);
    count_event<kWide>(bd, __ldg(col + i), __ldg(ys + i));
  }
  const int4* c4 = reinterpret_cast<const int4*>(col + a);
  const int4* y4 = reinterpret_cast<const int4*>(ys + a);
  const int groups = static_cast<int>((e - a) >> 2);
  // two groups of 4 events a thread a step: four 16-byte loads in flight
  int g = t;
  for (; g + kThreads < groups; g += 2 * kThreads) {
    const int4 c0 = __ldg(c4 + g), y0 = __ldg(y4 + g);
    const int4 c1 = __ldg(c4 + g + kThreads), y1 = __ldg(y4 + g + kThreads);
    count4<kWide>(bd, c0, y0);
    count4<kWide>(bd, c1, y1);
  }
  if (g < groups) count4<kWide>(bd, __ldg(c4 + g), __ldg(y4 + g));
}

template <bool kWide>
__device__ __forceinline__ unsigned count_at(const unsigned* cnt, int cell) {
  if (kWide) return cnt[cell];
  return reinterpret_cast<const unsigned short*>(cnt)[cell];
}

// 4 counters from `cell`, a multiple of 4
template <bool kWide>
__device__ __forceinline__ int4 count4_at(const unsigned* cnt, int cell) {
  if (kWide) {
    const uint4 v = reinterpret_cast<const uint4*>(cnt)[cell >> 2];
    return make_int4(v.x, v.y, v.z, v.w);
  }
  const uint2 v = reinterpret_cast<const uint2*>(cnt)[cell >> 2];
  return make_int4(v.x & 0xffffu, v.x >> 16, v.y & 0xffffu, v.y >> 16);
}

// The block's `cells` counters into the int32 planes at dst (4-byte aligned).
template <bool kWide>
__device__ __forceinline__ void write_planes(const unsigned* cnt, int32_t* dst, int cells) {
  const int t = threadIdx.x;
  const int head = min(cells, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
  if (t < head) dst[t] = static_cast<int32_t>(count_at<kWide>(cnt, t));
  const int groups = (cells - head) >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  if (head == 0) {
    for (int g = t; g < groups; g += kThreads) d4[g] = count4_at<kWide>(cnt, g << 2);
  } else {
    for (int g = t; g < groups; g += kThreads) {
      const int c = head + (g << 2);
      d4[g] = make_int4(count_at<kWide>(cnt, c), count_at<kWide>(cnt, c + 1),
                        count_at<kWide>(cnt, c + 2), count_at<kWide>(cnt, c + 3));
    }
  }
  for (int i = head + (groups << 2) + t; i < cells; i += kThreads) {
    dst[i] = static_cast<int32_t>(count_at<kWide>(cnt, i));
  }
}

__device__ __forceinline__ unsigned to_u8(unsigned c, int mode) {
  return mode == kRasterWrap ? (c & 255u) : min(c, 255u);
}

// Byte e of the block's raster rows: pixel e / 3, channel e % 3.
template <bool kWide>
__device__ __forceinline__ unsigned raster_byte(const unsigned* cnt, int e, int w, int mode) {
  const int pix = e / 3, ch = e - 3 * pix;
  if (ch == 1) return 0;
  const int row = pix / w, x = pix - row * w;
  return to_u8(count_at<kWide>(cnt, row * 2 * w + x + (ch == 2 ? w : 0)), mode);
}

// The block's rows as (rows, W, 3) uint8 at dst: 16 bytes a thread a step.
template <bool kWide>
__device__ __forceinline__ void write_raster(const unsigned* cnt, unsigned char* dst, int bytes,
                                             int w, int mode) {
  const int t = threadIdx.x;
  const int head = min(bytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  if (t < head) dst[t] = static_cast<unsigned char>(raster_byte<kWide>(cnt, t, w, mode));
  const int units = (bytes - head) >> 4;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const int w2 = 2 * w;
  for (int u = t; u < units; u += kThreads) {
    const int e0 = head + (u << 4);
    int pix = e0 / 3;
    int ch = e0 - 3 * pix;
    int row = pix / w;
    int x = pix - row * w;
    unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (ch != 1) {
        const unsigned v = to_u8(count_at<kWide>(cnt, row * w2 + x + (ch == 2 ? w : 0)), mode);
        word[j >> 2] |= v << ((j & 3) << 3);
      }
      if (++ch == 3) {
        ch = 0;
        if (++x == w) {
          x = 0;
          ++row;
        }
      }
    }
    d4[u] = make_uint4(word[0], word[1], word[2], word[3]);
  }
  for (int i = head + (units << 4) + t; i < bytes; i += kThreads) {
    dst[i] = static_cast<unsigned char>(raster_byte<kWide>(cnt, i, w, mode));
  }
}

// bounds: the (B, n_chunks) [min, max] valid y of every kChunk events, or
// null (every event of the sample is read). items = B * bands a sample.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
hist_band_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ ys,
                 const int2* __restrict__ bounds, void* __restrict__ out,
                 int n, int h, int w, int mode, int rows, int n_chunks, int items) {
  extern __shared__ __align__(16) unsigned char smem[];
  int& first_chunk = reinterpret_cast<int*>(smem)[0];
  int& last_chunk = reinterpret_cast<int*>(smem)[1];
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + kHeader);
  const int t = threadIdx.x;
  const int w2 = 2 * w;
  const int words = kWide ? rows * w2 : rows * w;   // w2 is even: two 16-bit counters a word
  const int bands = (h + rows - 1) / rows;

  Band bd;
  bd.base = static_cast<unsigned>(__cvta_generic_to_shared(cnt));
  bd.w2 = static_cast<unsigned>(w2);

  for (int item = static_cast<int>(blockIdx.x); item < items; item += gridDim.x) {
    const int b = item / bands;
    bd.row0 = (item - b * bands) * rows;
    bd.rows = static_cast<unsigned>(min(rows, h - bd.row0));
    const int row_end = bd.row0 + static_cast<int>(bd.rows);

    if (t == 0) {
      first_chunk = INT_MAX;
      last_chunk = -1;
    }
    uint4* c4 = reinterpret_cast<uint4*>(cnt);
    for (int i = t; i < (words >> 2); i += kThreads) c4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = ((words >> 2) << 2) + t; i < words; i += kThreads) cnt[i] = 0u;
    __syncthreads();   // the band is zeroed before any event lands

    // the band's events: the sample's, or (K4) the chunks from the first
    // to the last that meet the band; every chunk outside misses it
    const int64_t s = static_cast<int64_t>(b) * n;
    int64_t lo = s, hi = s + n;
    if (bounds != nullptr) {
      int first = INT_MAX, last = -1;
      for (int k = t; k < n_chunks; k += kThreads) {
        const int2 lh = __ldg(bounds + static_cast<int64_t>(b) * n_chunks + k);
        if (lh.y >= bd.row0 && lh.x < row_end) {
          first = min(first, k);
          last = max(last, k);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
        last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
      }
      if ((t & 31) == 0 && last >= 0) {
        atomicMin(&first_chunk, first);
        atomicMax(&last_chunk, last);
      }
      __syncthreads();
      lo = hi = s;
      if (last_chunk >= 0) {
        lo = s + static_cast<int64_t>(first_chunk) * kChunk;
        hi = s + min(static_cast<int64_t>(last_chunk + 1) * kChunk, static_cast<int64_t>(n));
      }
    }
    count_range<kWide>(col, ys, lo, hi, bd);
    __syncthreads();   // every event of the band has landed

    const int brows = static_cast<int>(bd.rows);
    const int64_t row = static_cast<int64_t>(b) * h + bd.row0;
    if (mode == kPlanes) {
      write_planes<kWide>(cnt, static_cast<int32_t*>(out) + row * w2, brows * w2);
    } else {
      write_raster<kWide>(cnt, static_cast<unsigned char*>(out) + row * w * 3, brows * w * 3,
                          w, mode);
    }
    __syncthreads();   // the band is read out before the next item zeroes it
  }
}

// min and max valid y of every chunk of kChunk events into the (B, n_chunks)
// bounds table (K4's skip): one warp per chunk, 8 chunks a block, grid
// (ceil(n_chunks / 8), B).
__global__ void __launch_bounds__(256)
chunk_bounds_kernel(const int32_t* __restrict__ ys, int2* __restrict__ bounds,
                    int n, int h, int n_chunks) {
  const int64_t b = blockIdx.y;
  const int c = blockIdx.x * 8 + static_cast<int>(threadIdx.x >> 5);
  if (c >= n_chunks) return;   // a whole warp: no block barrier below
  const int lane = threadIdx.x & 31;
  const int64_t lo = b * n + static_cast<int64_t>(c) * kChunk;
  const int64_t hi = b * n + min(static_cast<int64_t>(c + 1) * kChunk, static_cast<int64_t>(n));
  int64_t a, e;
  aligned_part(lo, hi, a, e);
  const unsigned uh = static_cast<unsigned>(h);
  int ylo = INT_MAX, yhi = -1;
  auto see = [&](int yi) {
    if (static_cast<unsigned>(yi) < uh) {
      ylo = min(ylo, yi);
      yhi = max(yhi, yi);
    }
  };
  const int head = static_cast<int>(a - lo);
  if (lane < head) see(__ldg(ys + lo + lane));
  else if (lane < head + static_cast<int>(hi - e)) see(__ldg(ys + e + (lane - head)));
  const int4* y4 = reinterpret_cast<const int4*>(ys + a);
  const int groups = static_cast<int>((e - a) >> 2);
#pragma unroll 4
  for (int g = lane; g < groups; g += 32) {
    const int4 v = __ldg(y4 + g);
    see(v.x);
    see(v.y);
    see(v.z);
    see(v.w);
  }
  for (int o = 16; o > 0; o >>= 1) {
    ylo = min(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
    yhi = max(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
  }
  if (lane == 0) bounds[b * n_chunks + c] = make_int2(ylo, yhi);
}

// Raise the kernel's dynamic shared memory to what a launch needs (only ever
// raised, so a smaller launch never lowers what a larger one set).
template <bool kWide>
cudaError_t opt_in(size_t smem) {
  static size_t opted_in = 0;   // the attribute is per kernel
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_band_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  return cudaSuccess;
}

// The launch the plan describes: `blocks` blocks, each `rows` rows of 2W
// counters of counter_bytes. Checks what the kernel relies on and returns the
// launch's error.
inline cudaError_t launch_bands(const int32_t* col, const int32_t* ys, const int2* bounds,
                                void* out, int b, int n, int h, int w, int mode,
                                int counter_bytes, int rows, int blocks, int n_chunks,
                                cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (n < 0 || static_cast<int64_t>(rows) * 2 * w > INT_MAX / 4) return cudaErrorInvalidValue;
  const bool wide = counter_bytes == 4;
  if ((!wide && counter_bytes != 2) || (!wide && n > kNarrowMaxN)) return cudaErrorInvalidValue;
  if (rows < 1 || blocks < 1 || mode < kPlanes || mode > kRasterClamp) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = band_smem(rows, w, wide);
  const int64_t items = static_cast<int64_t>(b) * ((h + rows - 1) / rows);
  if (smem > static_cast<size_t>(kMaxSmem) || items > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t ready = wide ? opt_in<true>(smem) : opt_in<false>(smem);
  if (ready != cudaSuccess) return ready;
  if (wide) {
    hist_band_kernel<true><<<blocks, kThreads, smem, stream>>>(
        col, ys, bounds, out, n, h, w, mode, rows, n_chunks, static_cast<int>(items));
  } else {
    hist_band_kernel<false><<<blocks, kThreads, smem, stream>>>(
        col, ys, bounds, out, n, h, w, mode, rows, n_chunks, static_cast<int>(items));
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace mem_hist
