// K4: the K1 count planes [pos | neg] from y-sorted events, by row bands.
//
// Replaces mem_tpu/ops/voxelize_pallas.py:_tiled_kernel
// (hist_planes_cols_sorted), the wide-canvas histogram of the DSEC 440x640
// raster and of bin-folded --voxel canvases. The TPU kernel turns the
// scatter into one-hot matrix products per (row tile, event chunk) and uses
// the y-sort to skip the tiles a chunk does not touch. Hopper has integer
// atomics in shared memory, so the sort buys something else here: a band of
// rows fits one block's shared memory (28 rows x 1280 columns x 4 B = 143 KB
// at the DSEC shape), the band's events are (nearly) one contiguous range of
// the sorted list, and the block counts them privately and writes its band
// once. No atomic reaches device memory and the output is never zero-filled.
//
//   out[b, ys[b, i], col[b, i]] += 1   for every event i with
//                                      0 <= col < 2W and 0 <= ys < H
//
// Two kernels in one launch of the entry point:
//
// 1. chunk_bounds_kernel: min and max valid y of every chunk of kChunk
//    events, one block per (chunk, sample), into a (B, n_chunks, 2) scratch
//    the wrapper allocates.
// 2. band_hist_kernel: one block per (band, sample). It walks the bounds
//    table (staged in shared memory, kTable entries at a time), reads only
//    the chunks whose [min, max] meets its band, adds the events of its
//    rows with shared-memory atomics and stores the band with 16-byte
//    writes. A band no event touches is still written, as zeros.
//
// The skip is conservative, as the TPU kernel's is: the result is exact for
// any event order and for invalid events anywhere in the list (ys outside
// [0, H) or col outside [0, 2W)); sorted input only makes each band read
// about N / n_bands events instead of N. Events of one row that straddle a
// chunk boundary are simply seen through both chunks.
//
// What bounds it on the H100: bytes. 8 x 180,000 events are 11.5 MB of
// (col, ys) read twice (the second time from L2) and an 18 MB output
// written once; the counting itself is one shared atomic per event. The
// band height is chosen so that bands x samples is about the number of SMs.
//
// Allocates nothing and does not synchronise.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 2048;          // events per bounds entry
constexpr int kTable = 1024;          // bounds entries staged at a time (8 KB)
constexpr int kMaxSmem = 232448;      // dynamic shared memory one block may use
constexpr int kMinBand = 4;           // rows: below this the write-out dominates

__global__ void __launch_bounds__(256)
chunk_bounds_kernel(const int32_t* __restrict__ ys, int2* __restrict__ bounds,
                    int n, int h, int n_chunks) {
  const int64_t b = blockIdx.y;
  const int c = blockIdx.x;
  const int32_t* y = ys + b * n;
  int lo = INT_MAX, hi = -1;
  const int end = min((c + 1) * kChunk, n);
  for (int i = c * kChunk + threadIdx.x; i < end; i += blockDim.x) {
    const int yi = __ldg(y + i);
    if (static_cast<unsigned>(yi) < static_cast<unsigned>(h)) {
      lo = min(lo, yi);
      hi = max(hi, yi);
    }
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

__global__ void __launch_bounds__(kThreads)
band_hist_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ ys,
                 const int2* __restrict__ bounds, int32_t* __restrict__ out,
                 int n, int h, int w2, int band_h, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* table = reinterpret_cast<int2*>(smem);                     // [kTable]
  int32_t* band = reinterpret_cast<int32_t*>(smem) + 2 * kTable;   // [band_h * w2]

  const int64_t b = blockIdx.y;
  const int row0 = blockIdx.x * band_h;
  const int rows = min(band_h, h - row0);
  const int cells = rows * w2;
  const int32_t* c = col + b * n;
  const int32_t* y = ys + b * n;

  for (int i = threadIdx.x; i < cells; i += kThreads) band[i] = 0;

  for (int t0 = 0; t0 < n_chunks; t0 += kTable) {
    const int nt = min(kTable, n_chunks - t0);
    __syncthreads();   // the band is zeroed / the last table is done with
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      table[i] = bounds[b * n_chunks + t0 + i];
    }
    __syncthreads();
    for (int k = 0; k < nt; ++k) {
      const int2 lh = table[k];
      if (lh.y < row0 || lh.x >= row0 + rows) continue;   // block-uniform
      const int start = (t0 + k) * kChunk;
      const int end = min(start + kChunk, n);
      for (int i = start + threadIdx.x; i < end; i += kThreads) {
        // unsigned arithmetic drops negatives, the sentinels and other bands
        const unsigned r = static_cast<unsigned>(__ldg(y + i)) - static_cast<unsigned>(row0);
        const unsigned ci = static_cast<unsigned>(__ldg(c + i));
        if (r < static_cast<unsigned>(rows) && ci < static_cast<unsigned>(w2)) {
          atomicAdd(band + r * w2 + ci, 1);
        }
      }
    }
  }
  __syncthreads();

  // w2 is even and the plane offsets are multiples of w2: 8-byte stores are
  // always aligned, 16-byte ones when w2 % 4 == 0
  int32_t* dst = out + (b * h + row0) * w2;
  if (w2 % 4 == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(band);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < cells / 4; i += kThreads) dst4[i] = src4[i];
  } else {
    const int2* src2 = reinterpret_cast<const int2*>(band);
    int2* dst2 = reinterpret_cast<int2*>(dst);
    for (int i = threadIdx.x; i < cells / 2; i += kThreads) dst2[i] = src2[i];
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
  }
  return sms;
}

}  // namespace

// Rows per band at (b, h, w): about one block per SM, at least kMinBand rows,
// at most what fits beside the bounds table; 0 when not even one row fits.
extern "C" int mem_hist_sorted_band_rows(int b, int h, int w) {
  const int row_bytes = 2 * w * 4;
  const int fit = (kMaxSmem - kTable * 8) / row_bytes;
  if (fit < 1 || b < 1 || h < 1) return 0;
  const int bands_wanted = (sm_count() + b - 1) / b;
  int rows = (h + bands_wanted - 1) / bands_wanted;
  if (rows < kMinBand) rows = kMinBand;
  if (rows > fit) rows = fit;
  if (rows > h) rows = h;
  return rows;
}

// Entries of the (B, n_chunks) int2 bounds scratch a launch at n events needs.
extern "C" int mem_hist_sorted_chunks(int n) { return (n + kChunk - 1) / kChunk; }

extern "C" int mem_hist_planes_cols_sorted(const int32_t* col, const int32_t* ys,
                                           int32_t* out, void* bounds, int b, int n,
                                           int h, int w, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int band_h = mem_hist_sorted_band_rows(b, h, w);
  if (band_h == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = mem_hist_sorted_chunks(n);
  const int n_bands = (h + band_h - 1) / band_h;   // grid.x: up to 2^31 - 1
  if (n_chunks > 0) {
    chunk_bounds_kernel<<<dim3(n_chunks, b), 256, 0, stream>>>(
        ys, static_cast<int2*>(bounds), n, h, n_chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = static_cast<size_t>(kTable) * 8 +
                      static_cast<size_t>(band_h) * 2 * w * 4;
  static size_t opted_in = 0;   // the attribute is per kernel: raise it as needed
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  band_hist_kernel<<<dim3(n_bands, b), kThreads, smem, stream>>>(
      col, ys, static_cast<const int2*>(bounds), out, n, h, 2 * w, band_h, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
