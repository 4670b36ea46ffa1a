// K1: exact per-sample event-count planes [pos | neg] from pre-packed columns,
// or the (B, H, W, 3) uint8 raster made from them.
//
// Replaces mem_tpu/ops/voxelize_pallas.py:_dense_kernel (hist_planes_cols),
// which builds one-hot factors in VMEM and contracts them on the TPU's
// matrix unit. On Hopper the same function is a scatter histogram into
// shared memory: the body in voxelize_hist.cuh (shared with K4), launched
// here without K4's chunk skip, so the events are read in any order. The
// plan (rows a block, blocks) comes from the wrapper, ops/voxelize_hist.py
// hist_plan.

#include "voxelize_hist.cuh"

// mode: 0 planes (B, H, 2W) int32, 1 raster mod 256, 2 raster min(count, 255)
// (B, H, W, 3) uint8. counter_bytes 2 needs n < 65,536.
extern "C" int mem_hist_planes_cols(const int32_t* col, const int32_t* ys, void* out, int b,
                                    int n, int h, int w, int mode, int counter_bytes,
                                    int rows, int blocks, cudaStream_t stream) {
  return static_cast<int>(mem_hist::launch_bands(col, ys, nullptr, out, b, n, h, w, mode,
                                                 counter_bytes, rows, blocks, 0, stream));
}
