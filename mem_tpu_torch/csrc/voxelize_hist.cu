// K1: exact per-sample event-count planes [pos | neg] from pre-packed columns.
//
// Replaces mem_tpu/ops/voxelize_pallas.py:_dense_kernel (hist_planes_cols),
// which builds one-hot factors in VMEM and contracts them on the TPU's
// matrix unit. That is a device choice for a chip without fast scatter; on
// Hopper the same function is a scatter histogram:
//
//   out[b, ys[b, i], col[b, i]] += 1   for every event i with
//                                      0 <= col < 2W and 0 <= ys < H
//
// col = x + W * (p < 0) (2W marks an invalid event), ys = y (H marks one),
// exactly the sentinels of voxelize_pallas.pack_cols.
//
// What bounds it on the H100: one (H, 2W) int32 plane at the 256x256
// N-Caltech101 canvas is 512 KB, more than the 227 KB of shared memory a
// block may hold, so the plane cannot be privatised per block. This first
// version therefore adds with int32 atomics straight into device memory
// (the L2 resolves them): the cost is one 8-byte event read plus one atomic
// per event, i.e. latency-bound on atomics, not on bandwidth. The grid is
// (event chunks, samples) with one event per thread per step, so many
// atomics are in flight at once. Integer atomics make the counts exact and
// independent of the order of events. Row tiles in shared memory and fusing
// the mod-256 wrap and the uint8 stack into this pass are later work.
//
// The kernel allocates nothing and does not synchronise: the caller hands
// in a zeroed (B, H, 2W) int32 output and PyTorch's current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hist_planes_cols_kernel(const int32_t* __restrict__ col,
                        const int32_t* __restrict__ ys,
                        int32_t* __restrict__ out,
                        int n, int h, int w2) {
  const int64_t b = blockIdx.y;
  const int32_t* c = col + b * n;
  const int32_t* y = ys + b * n;
  int32_t* plane = out + b * h * w2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int ci = __ldg(c + i);
    const int yi = __ldg(y + i);
    // unsigned compares drop negatives and the sentinels in one test each
    if (static_cast<unsigned>(ci) < static_cast<unsigned>(w2) &&
        static_cast<unsigned>(yi) < static_cast<unsigned>(h)) {
      atomicAdd(plane + static_cast<int64_t>(yi) * w2 + ci, 1);
    }
  }
}

}  // namespace

extern "C" int mem_hist_planes_cols(const int32_t* col, const int32_t* ys,
                                    int32_t* out, int b, int n, int h, int w,
                                    cudaStream_t stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // the grid-stride loop covers the rest
  hist_planes_cols_kernel<<<dim3(blocks, b), kThreads, 0, stream>>>(
      col, ys, out, n, h, 2 * w);
  return static_cast<int>(cudaGetLastError());
}
