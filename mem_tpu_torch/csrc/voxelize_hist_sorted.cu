// K4: the K1 count planes [pos | neg] (or the uint8 raster) from y-sorted
// events, by row bands that skip the event chunks they do not meet.
//
// Replaces mem_tpu/ops/voxelize_pallas.py:_tiled_kernel
// (hist_planes_cols_sorted), the wide-canvas histogram of the DSEC 440x640
// raster and of bin-folded --voxel canvases. The TPU kernel turns the scatter
// into one-hot matrix products per (row tile, event chunk) and uses the y-sort
// to skip the tiles a chunk does not touch. Here the body of
// voxelize_hist.cuh (shared with K1) counts a band of rows per block in shared
// memory, and the y-sort lets each band read only the chunks that meet it:
//
// 1. chunk_bounds_kernel: min and max valid y of every chunk of 2048 events,
//    one warp per (chunk, sample), into a (B, n_chunks, 2) scratch the
//    wrapper allocates.
// 2. hist_band_kernel: each band finds in the bounds table the first and the
//    last chunk whose [min, max] meets it and reads the chunks between them,
//    so about N / bands events instead of N. The skip is conservative, as
//    the TPU kernel's is: every chunk outside that range misses the band, so
//    the result is exact for any event order and for invalid events anywhere
//    in the list; a broken presort promise costs time, never counts.
//
// Unsorted events need no sort here: with bounds == null the body reads
// every event once per band (the wrapper passes that for presorted=False,
// the counts do not depend on order). The plan comes from the wrapper,
// ops/voxelize_hist.py hist_plan.

#include "voxelize_hist.cuh"

// bounds: a (B, ceil(n / 2048)) int2 scratch (2048 = kChunk, events a bounds
// entry), or null to read every event (no skip, no bounds pass). mode and
// counter_bytes as K1's.
extern "C" int mem_hist_planes_cols_sorted(const int32_t* col, const int32_t* ys, void* out,
                                           void* bounds, int b, int n, int h, int w, int mode,
                                           int counter_bytes, int rows, int blocks,
                                           cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (n + mem_hist::kChunk - 1) / mem_hist::kChunk;
  int2* table = bounds != nullptr && n_chunks > 0 ? static_cast<int2*>(bounds) : nullptr;
  if (table != nullptr) {
    mem_hist::chunk_bounds_kernel<<<dim3((n_chunks + 7) / 8, b), 256, 0, stream>>>(
        ys, table, n, h, n_chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(mem_hist::launch_bands(col, ys, table, out, b, n, h, w, mode,
                                                 counter_bytes, rows, blocks, n_chunks,
                                                 stream));
}
