// X2a, X2b, X2c: the voxelizer's second round of experiments
// (scripts/exp_voxelize2.py) on the H100's tensor cores, as wgmma.
//
// Replaces scripts/exp_voxelize2.py:49 _kernel_fused_i8 (X2a), :24
// _kernel_tiled (X2b) and :204 _kernel_tiled_i8 (X2c): two cuts of X1b's
// one-hot contraction (exp_voxelize.cu) of the count planes,
//
//   out[b] (rows, 2W) = onehot(ys)^T (rows x N) . onehot(col) (N x 2W)
//
// - X2a: X1b's dense contraction with int8 one-hots and int32 sums: rows =
//   H, out int32; K1's function (ys outside [0, H) and col outside [0, 2W)
//   add nothing).
// - X2b: a row-band accumulator that skips every (band, chunk) pair the
//   chunk's y range misses: rows = n_tiles * TH (n_tiles = ceil(H / TH)),
//   bf16 one-hots, f32 sums. Rows H <= y < n_tiles * TH are part of the
//   function, as in the pallas_call's output: an event there counts there
//   (the caller crops [:, :H]).
// - X2c: X2b with int8 one-hots and int32 sums.
//
// The skip. The reference's test, per band t of TH rows and per chunk of
// `chunk` events, is kept: the band computes the chunk only when max(ys) >=
// t * TH and min(ys) < (t + 1) * TH over the chunk's events, invalid ones
// included. A bounds pass (chunk_minmax_kernel) writes min and max of ys
// over every chunk into a (B, n_chunks, 2) int32 scratch the wrapper
// allocates; the contraction kernel's block then walks only the chunks that
// pass the test for one of the bands its rows span (the union of two bands at
// TH = 32; at TH = 128 two blocks make the same band's test), decided before
// any event is staged: a chunk the block skips costs neither a copy nor a
// build. It is exact for any event order (a skipped chunk has no y in the
// block's rows); y-sorted events only make it skip more. `chunk` is the
// skip's grain alone: a kept chunk is staged in pieces of at most `stage`
// events (the plan's), so every chunk of the reference's sweeps fits. The
// ragged last chunk is masked in the kernel: nothing is padded, and without
// the reference's sentinel padding its max is lower, which skips more and
// changes no count.
//
// Design, X1's (exp_voxelize.cu) with int8 beside bf16: a block owns a tile
// of one sample's plane and streams the events of its stages through it.
// - a producer warp fills a ring of two event stages with 1-D bulk copies on
//   mbarriers (16-byte aligned: a stage copies from the aligned word below
//   its first event; the at most three events past its last aligned word are
//   read from device memory);
// - two builder warpgroups, taking the slots of the ring in turn, write the
//   one-hot operands of each slot K-major in the 128-byte swizzle: a slot is
//   one or two K-blocks (see OneHot), each a 128-byte row of events, 64 in
//   bf16 and 128 in int8. Each event writes its one value into A and into B,
//   half a warpgroup an operand, one to four events a thread, and the same
//   thread writes zero back at the same place once the slot's products are
//   done;
// - two consumer warpgroups issue wgmma (bf16 m64nNk16 into f32, s8
//   m64nNk32 into s32: gemm_sm90.cuh's wgmma_onehot), four 32-byte k steps a
//   K-block, keep the last slot's products in flight and hand a slot back
//   once its products are done;
// - the accumulators are written once, from registers: no fill, no atomics.
// The tile is 64 rows (wgmma's m: A = onehot(ys), shared by both consumers)
// x 2N columns (B = onehot(col), N each), N = 96 or 128, the launch plan's
// choice (mem_tpu_torch/tools/exp_voxelize2.py x2_plan). At TH = 32 a tile
// takes the union of its two bands. The band as wgmma's n (a 128-column x
// TH-row tile, TH = 32 keeping its own cut) lost by ~1.5x at the best (TH,
// chunk) of each dtype: it visits each event from more blocks, and its
// narrow products read more shared memory per operation (PERF.md, X2).
//
// What bounds it on the H100: not the bytes (29.9 MB at the seg shape, 0.009
// ms) but the contraction of the one-hots, zeros included, at the int8 peak
// (1,979 TOP/s: 2 * 8 * 180,224 * 440 * 1,280 = 1.62 TOP dense, 0.82 ms; the
// pairs the skip keeps on sorted events, 0.07-0.27 ms) or the bf16 peak
// (989 TFLOP/s), and the builders' stores, one a block per event and
// operand.
//
// Numerics: one-hot products are exact, int32 sums exact, f32 sums of counts
// exact below 2^24 (a cell gets at most N = 180,224 events): every variant
// equals its plain version bit for bit.
//
// Allocates nothing and does not synchronise.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"   // hopper.cuh's helpers, wgmma_onehot, fence_acc

namespace {

constexpr int kRingBlocks = 4;                  // the one-hot ring, in K-blocks
constexpr int kConsumers = 256;                 // two warpgroups of products
constexpr int kBuilders = 256;                  // two warpgroups writing the one-hots
constexpr int kThreads = kConsumers + kBuilders + 32;   // and the producer warp
constexpr int kRowBytes = 128;                  // a slot's operand row: one swizzle row
constexpr int kMaxSmem = 232448;                // what one block may use
constexpr uint32_t kNone = 0xFFFFFFFFu;         // no entry written

// kS8: int8 one-hots and int32 sums (X2a, X2c); else bf16 and f32 (X2b). A
// slot is kKB K-blocks, each one 128-byte swizzle row of events (64 bf16 or
// 128 int8) in A and B; the ring holds kRingBlocks of them. At N = 96 a slot
// is two K-blocks (two slots in the ring: half the builders' waits, fences
// and arrivals per event), at N = 128 one (four slots: more slack for the
// longer products): each the faster at its width (PERF.md, X2).
template <bool kS8, int N>
struct OneHot {
  using Acc = typename std::conditional<kS8, int32_t, float>::type;
  static constexpr int kKB = N == 96 ? 2 : 1;
  static constexpr int kDepth = kKB * (kS8 ? 128 : 64);   // events of a slot
  static constexpr int kSlots = kRingBlocks / kKB;         // slots of the ring
  // even: a slot is always built by the same builder warpgroup, so the
  // thread that wrote an entry is the one that zeroes it
  static_assert(kSlots % 2 == 0, "the builder warpgroups take the slots in turn");
};

constexpr int kRows = 64;                       // a block's rows: wgmma's m
constexpr int kABytes = kRows * kRowBytes;      // an A K-block: onehot(ys), 8 KB
template <int N>
constexpr int kBBytes = 2 * N * kRowBytes;      // a B K-block: both consumers' columns

// shared memory of a launch: the 1024 B in front align the rings for the
// swizzle; then the A and B rings, the two event stages (col and ys arrays of
// stage + 4 int32 each: the copy may start up to three words early) and the
// mbarriers (full and empty of each stage and each slot)
template <int N>
constexpr size_t smem_bytes(int stage) {
  return 1024 + static_cast<size_t>(kRingBlocks) * (kABytes + kBBytes<N>) +
         static_cast<size_t>(2) * 2 * (stage + 4) * 4 + 16 * (2 + kRingBlocks);
}

template <bool kS8>
__device__ __forceinline__ void st_onehot(uint32_t addr, bool one) {
  if constexpr (kS8) {
    asm volatile("st.shared.u8 [%0], %1;" :: "r"(addr), "h"(uint16_t(one ? 1 : 0)) : "memory");
  } else {
    asm volatile("st.shared.u16 [%0], %1;" :: "r"(addr), "h"(uint16_t(one ? 0x3F80 : 0))
                 : "memory");   // bf16 1.0
  }
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" :: "r"(addr), "r"(0) : "memory");
}

// byte offset of byte b of row `row` of a K-major tile of 128-byte rows in the
// 128 B swizzle: 16-byte chunk b / 16 of the row, XOR the row mod 8
__device__ __forceinline__ uint32_t sw128(unsigned row, int b) {
  return row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

// The event stages a block consumes: every chunk of `chunk` events of its
// sample whose [min ys, max ys] meets the rows [lo, hi) of the bands its tile
// spans (every chunk without a bounds table), each cut into stages of at most
// `stage` events.
struct Walk {
  const int2* bounds;   // this sample's (min, max) of ys over each chunk, or null
  int n, chunk, stage, n_chunks, lo, hi;
  int c = 0, off = 0;   // the stage: events c * chunk + off + [0, len())

  __device__ bool kept(int k) const {
    if (bounds == nullptr) return true;
    const int2 lh = bounds[k];
    return lh.y >= lo && lh.x < hi;
  }
  __device__ int chunk_len(int k) const { return min(chunk, n - k * chunk); }
  __device__ void seek(int k) {   // the first kept chunk from k
    while (k < n_chunks && !kept(k)) ++k;
    c = k;
    off = 0;
  }
  __device__ bool done() const { return c >= n_chunks; }
  __device__ int first() const { return c * chunk + off; }
  __device__ int len() const { return min(stage, chunk_len(c) - off); }
  __device__ void next() {
    off += stage;
    if (off >= chunk_len(c)) seek(c + 1);
  }
  // the slots of depth events over every kept chunk (a stage is a whole
  // number of slots or a whole chunk, so a chunk's last slot may be short)
  __device__ int slots(int depth) const {
    int s = 0;
    for (int k = 0; k < n_chunks; ++k) {
      if (kept(k)) s += (chunk_len(k) + depth - 1) / depth;
    }
    return s;
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

// bounds: the (B, n_chunks) table of the tiled kernels (X2b, X2c; rows =
// n_tiles * TH), or null for X2a (rows = H, every chunk consumed). Grid:
// (column tiles of 2N, row tiles of 64, samples). Threads: the consumer
// warpgroups 0 and 1, the builder warpgroups 2 and 3, the producer warp.
template <bool kS8, int N>
__global__ void __launch_bounds__(kThreads, 1)
x2_wgmma_kernel(const int32_t* __restrict__ col, const int32_t* __restrict__ ys,
                const int2* __restrict__ bounds, typename OneHot<kS8, N>::Acc* __restrict__ out,
                int n, int rows, int w, int chunk, int stage, int th) {
  using Acc = typename OneHot<kS8, N>::Acc;
  constexpr int kB = kBBytes<N>;
  constexpr int kKB = OneHot<kS8, N>::kKB;
  constexpr int kDepth = OneHot<kS8, N>::kDepth;
  constexpr int kSlots = OneHot<kS8, N>::kSlots;
  constexpr int kPer = kDepth / 64;              // events of a builder thread in a slot
  constexpr int kElem = kS8 ? 1 : 2;             // bytes of a one-hot value
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023) & ~uint32_t{1023};       // A ring
  const uint32_t sb = sa + kRingBlocks * kABytes;            // B ring
  const int stride = stage + 4;                              // int32 of an array in a stage
  const uint32_t se = sb + kRingBlocks * kB;                 // event stages
  const uint32_t ev_full = se + 2 * 2 * stride * 4, ev_empty = ev_full + 16;
  const uint32_t slot_full = ev_empty + 16, slot_empty = slot_full + 8 * kSlots;
  const int32_t* events = reinterpret_cast<const int32_t*>(smem_raw + (se - raw));

  const int c0 = blockIdx.x * 2 * N, r0 = blockIdx.y * kRows;   // the tile
  const int64_t b = blockIdx.z;
  const int n_chunks = (n + chunk - 1) / chunk;
  Walk walk{bounds == nullptr ? nullptr : bounds + b * n_chunks, n, chunk, stage, n_chunks,
            0, 0};
  if (bounds != nullptr) {   // the rows of the bands the tile spans
    walk.lo = r0 / th * th;
    walk.hi = (min(r0 + kRows, rows) + th - 1) / th * th;
  }

  for (uint32_t off = threadIdx.x * 16; off < kRingBlocks * (kABytes + kB);
       off += kThreads * 16) {
    st_shared_zero16(sa + off);
  }
  fence_async_smem();   // the zeros, before the first product reads them
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(ev_full + 8 * s, 1);
      mbar_init(ev_empty + 8 * s, kBuilders);
    }
    for (int u = 0; u < kSlots; ++u) {
      mbar_init(slot_full + 8 * u, kBuilders / 2);
      mbar_init(slot_empty + 8 * u, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers + kBuilders) {
    // producer warp: one lane keeps the two event stages full
    if (threadIdx.x != kConsumers + kBuilders) return;
    const int32_t* src[2] = {col, ys};
    walk.seek(0);
    for (int k = 0; !walk.done(); ++k, walk.next()) {
      const int s = k & 1;
      if (k >= 2) mbar_wait(ev_empty + 8 * s, ((k >> 1) - 1) & 1);
      const int64_t first = b * n + walk.first();
      const int64_t lo = first & ~int64_t{3}, hi = (first + walk.len()) & ~int64_t{3};
      const uint32_t bytes = static_cast<uint32_t>(hi - lo) * 4;
      mbar_expect_tx(ev_full + 8 * s, bytes * 2);
      if (bytes > 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bulk_load(se + (s * 2 + q) * stride * 4, src[q] + lo, bytes, ev_full + 8 * s);
        }
      }
    }
    return;
  }

  const int slots = walk.slots(kDepth);
  if (threadIdx.x >= kConsumers) {
    // builder warpgroups: warpgroup bw builds the slots u = bw mod 2 of the
    // ring, the other's in turn; its thread bt writes the entries of events
    // e + 64 j (j < kPer) of each: role 0 in A, role 1 in B, and zeroes them
    // again once the slot's products are done
    const int bw = (threadIdx.x - kConsumers) / 128, bt = threadIdx.x % 128;
    const int e = bt & 63, role = bt / 64;
    // A holds onehot(ys) over the rows, B onehot(col) over the columns
    const int q = role == 0 ? 1 : 0;                         // the array: col 0, ys 1
    const int org = role == 0 ? r0 : c0;
    const unsigned ext = role == 0 ? kRows : 2 * N;
    const uint32_t ring = role == 0 ? sa : sb;
    const uint32_t block = role == 0 ? kABytes : kB;          // a K-block of the operand
    const int32_t* gsrc = role == 0 ? ys : col;
    uint32_t old[kSlots][kPer];   // this thread's entries in each slot of the ring
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) old[u][j] = kNone;
    }
    int k = 0, i = 0, ns = 0;     // the stage, the slot in it, its slots
    int len = 0, head = 0, copied = 0;
    int64_t first = 0;
    const int32_t* stage_q = events;
    walk.seek(0);
    for (int s0 = 0; s0 < slots; s0 += kSlots) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (s0 + u < slots) {
          if (i == 0) {
            first = b * n + walk.first();
            len = walk.len();
            ns = (len + kDepth - 1) / kDepth;
            head = static_cast<int>(first & 3);
            copied = static_cast<int>(((first + len) & ~int64_t{3}) - (first & ~int64_t{3}));
            stage_q = events + ((k & 1) * 2 + q) * stride;
            mbar_wait(ev_full + 8 * (k & 1), (k >> 1) & 1);
          }
          if ((u & 1) == bw) {
            // the loads first: one wait for them
            int v[kPer];
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const int ev = i * kDepth + e + 64 * j;   // the event in the stage
              // (INT_MIN: no event, hits no row or column)
              v[j] = ev >= len ? INT_MIN
                               : head + ev < copied ? stage_q[head + ev] : __ldg(gsrc + first + ev);
            }
            // the products that read this slot kSlots slots ago are done
            if (s0 > 0) mbar_wait(slot_empty + 8 * u, ((s0 / kSlots) - 1) & 1);
            const uint32_t slot = ring + u * kKB * block;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              if (old[u][j] != kNone) st_onehot<kS8>(old[u][j], false);
              const unsigned rel = static_cast<unsigned>(v[j]) - static_cast<unsigned>(org);
              const int byte = (e + 64 * j) * kElem;   // in the slot's K-blocks
              const uint32_t at = rel < ext ? slot + (byte >> 7) * block + sw128(rel, byte & 127)
                                            : kNone;
              if (at != kNone) st_onehot<kS8>(at, true);
              old[u][j] = at;
            }
            fence_async_smem();
            mbar_arrive(slot_full + 8 * u);
          }
          if (i == ns - 1) mbar_arrive(ev_empty + 8 * (k & 1));
          if (++i == ns) {
            i = 0;
            ++k;
            walk.next();
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: wgmma on each slot as it is built, one slot in
  // flight while the next is issued; a slot goes back to the builders once
  // its products are done. Warpgroup wg takes all of A and B's columns
  // N wg + [0, N).
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  Acc acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = Acc(0);
  for (int s0 = 0; s0 < slots; s0 += kSlots) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (s0 + u < slots) {
        mbar_wait(slot_full + 8 * u, (s0 / kSlots) & 1);
        const uint32_t slot_a = sa + u * kKB * kABytes;
        const uint32_t slot_b = sb + u * kKB * kB + wg * N * kRowBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKB * kRowBytes / 32; ++kk) {   // 32-byte k steps
          const uint32_t at = 32 * (kk % 4);
          wgmma_onehot<N>(acc, sw128_desc(slot_a + (kk / 4) * kABytes + at),
                          sw128_desc(slot_b + (kk / 4) * kB + at));
        }
        wgmma_commit();
        wgmma_wait<1>();   // the last slot's products are done
        if (s0 + u > 0 && lane == 0) mbar_arrive(slot_empty + 8 * ((u + kSlots - 1) % kSlots));
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the accumulator of m64nN: warp p of the warpgroup holds rows 16 p + g and
  // 16 p + g + 8, columns 8 j + 2 t and + 1 (g = lane / 4, t = lane % 4)
  using Acc2 = typename std::conditional<kS8, int2, float2>::type;
  const int g = lane / 4, t = lane % 4, w2 = 2 * w;
  const int ra = r0 + (tid / 32) % 4 * 16 + g;
  const int cb = c0 + wg * N + 2 * t;
  Acc* plane = out + b * rows * static_cast<int64_t>(w2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = cb + 8 * j;
    if (c >= w2) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ra + 8 * h < rows) {
        Acc2 v;
        v.x = acc[4 * j + 2 * h];
        v.y = acc[4 * j + 2 * h + 1];
        *reinterpret_cast<Acc2*>(plane + static_cast<int64_t>(ra + 8 * h) * w2 + c) = v;
      }
    }
  }
}

template <bool kS8, int N>
int launch(const int32_t* col, const int32_t* ys, typename OneHot<kS8, N>::Acc* out,
           int2* bounds, int b, int n, int h, int w, int th, int chunk, int stage,
           cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes<N>(stage);
  constexpr int block = kRowBytes / (kS8 ? 1 : 2);   // events of a K-block
  const bool tiled = bounds != nullptr;
  // a stage is a whole number of slots, or a whole chunk (whose last slot
  // may be half empty: Walk::slots counts it so)
  if (b > 65535 || n < 0 || chunk <= 0 || chunk % block != 0 || stage <= 0 ||
      stage % block != 0 || stage > chunk ||
      (stage % OneHot<kS8, N>::kDepth != 0 && stage != chunk) || smem > kMaxSmem ||
      (tiled && (th <= 0 || th % 32 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = tiled ? (h + th - 1) / th * th : h;
  const int n_chunks = n / chunk + (n % chunk != 0);
  if (tiled && n_chunks > 0) {
    chunk_minmax_kernel<<<dim3(n_chunks, b), 256, 0, stream>>>(ys, bounds, n, chunk, n_chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static size_t opted = 48 * 1024;   // the attribute is per kernel: raise it as needed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(x2_wgmma_kernel<kS8, N>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid((2 * w + 2 * N - 1) / (2 * N), (rows + kRows - 1) / kRows, b);
  x2_wgmma_kernel<kS8, N><<<grid, kThreads, smem, stream>>>(col, ys, bounds, out, n, rows, w,
                                                             chunk, stage, th);
  return static_cast<int>(cudaGetLastError());
}

// the plan's tile width: N = tile_n, 96 or 128
template <bool kS8, typename Acc>
int launch_plan(const int32_t* col, const int32_t* ys, Acc* out, int2* bounds, int b, int n,
                int h, int w, int th, int chunk, int stage, int tile_n, cudaStream_t stream) {
  switch (tile_n) {
    case 96: return launch<kS8, 96>(col, ys, out, bounds, b, n, h, w, th, chunk, stage, stream);
    case 128: return launch<kS8, 128>(col, ys, out, bounds, b, n, h, w, th, chunk, stage, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// X2a: col, ys int32 (b, n), 16-byte aligned; out (b, h, 2w) int32; chunk the
// events of a stage, a multiple of 128; tile_n (96 or 128) the plan's.
extern "C" int mem_exp_voxelize2_fused_i8(const int32_t* col, const int32_t* ys, int32_t* out,
                                          int b, int n, int h, int w, int chunk, int tile_n,
                                          cudaStream_t stream) {
  return launch_plan<true>(col, ys, out, nullptr, b, n, h, w, 1, chunk, chunk, tile_n,
                           stream);
}

// X2b: col, ys int32 (b, n), 16-byte aligned; out (b, ceil(h / th) * th, 2w)
// f32; bounds an int32 (b, ceil(n / chunk), 2) scratch; th a multiple of 32;
// chunk a multiple of 64; stage (the events of a stage) chunk or a multiple of
// the slot below it (N = 96: 128 events, N = 128: 64); tile_n (96 or 128)
// the plan's.
extern "C" int mem_exp_voxelize2_tiled(const int32_t* col, const int32_t* ys, float* out,
                                       void* bounds, int b, int n, int h, int w, int th,
                                       int chunk, int stage, int tile_n, cudaStream_t stream) {
  if (bounds == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_plan<false>(col, ys, out, static_cast<int2*>(bounds), b, n, h, w, th, chunk,
                            stage, tile_n, stream);
}

// X2c: X2b's arguments, out int32; chunk a multiple of 128, the slot 256
// events at N = 96, 128 at N = 128.
extern "C" int mem_exp_voxelize2_tiled_i8(const int32_t* col, const int32_t* ys, int32_t* out,
                                          void* bounds, int b, int n, int h, int w, int th,
                                          int chunk, int stage, int tile_n,
                                          cudaStream_t stream) {
  if (bounds == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_plan<true>(col, ys, out, static_cast<int2*>(bounds), b, n, h, w, th, chunk,
                           stage, tile_n, stream);
}

