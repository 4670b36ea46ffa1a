// X1a, X1b, X1c: the voxelizer experiment's one-hot contractions
// (scripts/exp_voxelize.py) on the H100's tensor cores, as wgmma.
//
// Replaces scripts/exp_voxelize.py:25 _kernel_base (X1a), :47
// _kernel_fused_onehot (X1b) and :66 _kernel_fused_loop (X1c), three TPU
// formulations of the count planes that K1 (csrc/voxelize_hist.cu) counts in
// shared memory: one-hot factors built in VMEM and contracted on the matrix
// unit,
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
// Hopper beside K1, so the kernels keep it: every event enters every output
// tile of its sample as a one-hot column of a bf16 product with f32
// accumulators, the zeros included. What bounds that is the contraction at
// the bf16 dense peak, not the histogram's bytes: at the seg shape (8 x
// 180,224 events, 440 x 1280 planes) 2 * 8 * 180,224 * 440 * 1280 = 1.62
// TFLOP, 1.64 ms at 989 TFLOP/s; at cls (64 x 30,720, 256 x 512) 0.52 ms.
//
// Design. A block owns a 64-row x 2N-column tile of one sample's plane (N =
// 96 or 128, the launch plan's choice: mem_tpu_torch/tools/exp_voxelize.py
// x1_plan counts the waves on the card's SMs) and streams all of the
// sample's events through it:
// - a producer warp fills a ring of two event stages, `chunk` events each,
//   with 1-D bulk copies on mbarriers (16-byte aligned: a stage copies from
//   the aligned word below its first event, and the at most three events past
//   the last aligned word of a ragged stage are read from device memory);
// - two builder warpgroups, taking the slots of a ring of four in turn,
//   write the operands of each 64-event slot: A (64 rows x 64 events) and B
//   (2N columns x 64 events), both K-major bf16 in the 128-byte swizzle,
//   zeroed once at the start. Each event writes its one value into A (1.0 at
//   row y) and into B (1.0 at column col; X1a: bf16(wpos) at x and
//   bf16(wneg) at W + x), one thread an event and operand: O(1)
//   shared-memory stores a block per event. Once the products that read the
//   slot have completed, the same threads write zeros back at the same
//   places, before the slot's next events;
// - two consumer warpgroups each issue wgmma m64nNk16 (both operands from
//   shared memory) on their N columns of B, four k16 steps a slot, as each
//   slot is built (mbarriers), keep the last slot's products in flight, and
//   hand a slot back to its builders once its products are done: the
//   builders run up to two slots ahead of the products;
// - the accumulators are written once, from registers, as float2 stores:
//   no zero fill and no atomics.
//
// Numerics: the one-hot products are exact and the f32 sums of integer
// counts stay exact below 2^24 (a cell gets at most N = 180,224 events), so
// X1b and X1c equal K1's plain version bit for bit; X1a does as long as
// every partial sum of bf16 weights is representable (dyadic weights).
//
// The reference's `chunk` is the events of one ring stage (a multiple of the
// 64-event slot); X1c stages `inner` events at a time, so its wrapper
// launches X1b's entry point with chunk = inner (after checking that inner
// divides chunk: the reference loops chunk // inner times and drops the tail
// of every chunk otherwise). `bgroup`, a TPU block constraint, has no
// counterpart. No event is skipped: skipping by row band is K4's and X2's.
//
// Allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"   // hopper.cuh's helpers, wgmma_n128, fence_acc

namespace {

constexpr int kRows = 64;                       // a block's rows: wgmma's m
constexpr int kDepth = 64;                      // events of a slot: one 128-byte bf16 row
constexpr int kSlots = 4;                       // the one-hot ring
constexpr int kConsumers = 256;                 // two warpgroups of products
constexpr int kBuilders = 256;                  // two warpgroups writing the one-hots
constexpr int kThreads = kConsumers + kBuilders + 32;   // and the producer warp
constexpr int kABytes = kRows * kDepth * 2;     // an A slot, 8 KB
constexpr int kMaxSmem = 232448;                // what one block may use
constexpr uint16_t kOne = 0x3F80;               // bf16 1.0
constexpr uint32_t kNone = 0xFFFFFFFFu;         // no entry written

template <int N>
constexpr int kBBytes = 2 * N * kDepth * 2;     // a B slot: both warpgroups' columns

// shared memory of a launch: the 1024 B in front align the rings for the
// swizzle; then the A and B rings, the two event stages (words arrays of
// chunk + 4 int32 each: the copy may start up to three words early) and the
// mbarriers (full and empty of each stage and each slot)
template <int N>
constexpr size_t smem_bytes(int words, int chunk) {
  return 1024 + static_cast<size_t>(kSlots) * (kABytes + kBBytes<N>) +
         static_cast<size_t>(2) * words * (chunk + 4) * 4 + 16 * (2 + kSlots);
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;" :: "r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" :: "r"(addr), "r"(0) : "memory");
}

// byte offset of element (row, k) of a K-major tile of 128-byte rows in the
// 128 B swizzle: 16-byte chunk k / 8 of the row, XOR the row mod 8
__device__ __forceinline__ uint32_t sw128(unsigned row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// d += a b over one k16 step: wgmma m64n96k16, both operands K-major in
// shared memory (gemm_sm90.cuh's wgmma_n128 is the N = 128 one)
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_x1(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 96) {
    wgmma_n96(d, a, b);
  } else {
    wgmma_n128<0>(d, a, b, 1);
  }
}

// kRaw: X1a's four raw arrays (a = xs, ys, wpos, wneg); else X1b's packed
// (a = col, ys). Grid: (column tiles of 2N, row tiles of 64, samples).
// Threads: the consumer warpgroups 0 and 1, the builder warpgroups 2 and
// 3, the producer warp.
template <bool kRaw, int N>
__global__ void __launch_bounds__(kThreads, 1)
x1_wgmma_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ ys,
                const float* __restrict__ wpos, const float* __restrict__ wneg,
                float* __restrict__ out, int n, int h, int w, int chunk) {
  constexpr int kWords = kRaw ? 4 : 2;
  constexpr int kB = kBBytes<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023) & ~uint32_t{1023};       // A ring
  const uint32_t sb = sa + kSlots * kABytes;                 // B ring
  const int stride = chunk + 4;                              // int32 of an array in a stage
  const uint32_t se = sb + kSlots * kB;                      // event stages
  const uint32_t ev_full = se + 2 * kWords * stride * 4, ev_empty = ev_full + 16;
  const uint32_t slot_full = ev_empty + 16, slot_empty = slot_full + 8 * kSlots;
  const int32_t* events = reinterpret_cast<const int32_t*>(smem_raw + (se - raw));

  const int c0 = blockIdx.x * 2 * N, r0 = blockIdx.y * kRows;
  const int64_t b = blockIdx.z;
  const int stages = (n + chunk - 1) / chunk;
  const int per_stage = chunk / kDepth;
  const int slots = n <= 0 ? 0 : (stages - 1) * per_stage +
                                     (n - (stages - 1) * chunk + kDepth - 1) / kDepth;

  for (uint32_t off = threadIdx.x * 16; off < kSlots * (kABytes + kB); off += kThreads * 16) {
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
    const int32_t* src[4] = {a, ys, reinterpret_cast<const int32_t*>(wpos),
                             reinterpret_cast<const int32_t*>(wneg)};
    for (int k = 0; k < stages; ++k) {
      const int s = k & 1;
      if (k >= 2) mbar_wait(ev_empty + 8 * s, ((k >> 1) - 1) & 1);
      const int64_t first = b * n + static_cast<int64_t>(k) * chunk;
      const int len = min(chunk, n - k * chunk);
      const int64_t lo = first & ~int64_t{3}, hi = (first + len) & ~int64_t{3};
      const uint32_t bytes = static_cast<uint32_t>(hi - lo) * 4;
      mbar_expect_tx(ev_full + 8 * s, bytes * kWords);
      if (bytes > 0) {
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          bulk_load(se + (s * kWords + q) * stride * 4, src[q] + lo, bytes, ev_full + 8 * s);
        }
      }
    }
    return;
  }

  if (threadIdx.x >= kConsumers) {
    // builder warpgroups: warpgroup bw builds the slots u = bw mod 2 of the
    // ring, the other's in turn; its thread bt writes the entries of event e
    // of each: role 0 its A entry, role 1 its B entry (X1a: two, wpos at x
    // and wneg at W + x), and zeroes them again once the slot's products are
    // done
    const int bw = (threadIdx.x - kConsumers) / 128, bt = threadIdx.x % 128;
    const int e = bt & (kDepth - 1), role = bt / kDepth;
    const int32_t* gpos = reinterpret_cast<const int32_t*>(wpos);
    const int32_t* gneg = reinterpret_cast<const int32_t*>(wneg);
    uint32_t old[kSlots][2];   // this thread's entries in each slot of the ring
#pragma unroll
    for (int u = 0; u < kSlots; ++u) old[u][0] = old[u][1] = kNone;
    int k = 0, i = 0;          // the stage, the slot in it
    int len = 0, head = 0, copied = 0;
    int64_t first = 0;
    const int32_t* stage = events;
    // event ev of the stage, array q: from the stage, or past its last
    // aligned word from device memory
    auto load = [&](int q, const int32_t* g, int ev) {
      return head + ev < copied ? stage[q * stride + head + ev] : __ldg(g + first + ev);
    };
    for (int s0 = 0; s0 < slots; s0 += kSlots) {
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (s0 + u < slots) {
          if (i == 0) {
            first = b * n + static_cast<int64_t>(k) * chunk;
            len = min(chunk, n - k * chunk);
            head = static_cast<int>(first & 3);
            copied = static_cast<int>(((first + len) & ~int64_t{3}) - (first & ~int64_t{3}));
            stage = events + (k & 1) * kWords * stride;
            mbar_wait(ev_full + 8 * (k & 1), (k >> 1) & 1);
          }
          if ((u & 1) == bw) {
            // the products that read this slot kSlots slots ago are done
            if (s0 > 0) mbar_wait(slot_empty + 8 * u, ((s0 / kSlots) - 1) & 1);
            const uint32_t slot_a = sa + u * kABytes, slot_b = sb + u * kB;
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              if (old[u][x] != kNone) st_shared_u16(old[u][x], 0);
            }
            uint32_t at[2] = {kNone, kNone};
            uint16_t val[2] = {kOne, kOne};
            const int ev = i * kDepth + e;   // the event in the stage
            if (ev < len) {
              if (role == 0) {                                  // A: row y
                const unsigned rel = static_cast<unsigned>(load(1, ys, ev) - r0);
                if (rel < static_cast<unsigned>(kRows)) at[0] = slot_a + sw128(rel, e);
              } else if constexpr (kRaw) {                      // B: columns x, W + x
                // the three loads first: one wait for them, not two
                const int x = load(0, a, ev);
                val[0] = bf16_bits(__int_as_float(load(2, gpos, ev)));
                val[1] = bf16_bits(__int_as_float(load(3, gneg, ev)));
                if (static_cast<unsigned>(x) < static_cast<unsigned>(w)) {   // else nothing
                  const unsigned rp = static_cast<unsigned>(x - c0);
                  const unsigned rn = static_cast<unsigned>(x + w - c0);
                  if (rp < static_cast<unsigned>(2 * N)) at[0] = slot_b + sw128(rp, e);
                  if (rn < static_cast<unsigned>(2 * N)) at[1] = slot_b + sw128(rn, e);
                }
              } else {                                          // B: column col
                const unsigned rel = static_cast<unsigned>(load(0, a, ev) - c0);
                if (rel < static_cast<unsigned>(2 * N)) at[0] = slot_b + sw128(rel, e);
              }
            }
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              if (at[x] != kNone) st_shared_u16(at[x], val[x]);
              old[u][x] = at[x];
            }
            fence_async_smem();
            mbar_arrive(slot_full + 8 * u);
          }
          if (i == per_stage - 1 || s0 + u == slots - 1) mbar_arrive(ev_empty + 8 * (k & 1));
          if (++i == per_stage) {
            i = 0;
            ++k;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: wgmma on each slot as it is built, one slot in
  // flight while the next is issued; a slot goes back to the builders once
  // its products are done
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < slots; s0 += kSlots) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (s0 + u < slots) {
        mbar_wait(slot_full + 8 * u, (s0 / kSlots) & 1);
        const uint32_t slot_a = sa + u * kABytes, slot_b = sb + u * kB + wg * N * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          wgmma_x1<N>(acc, sw128_desc(slot_a + 32 * kk), sw128_desc(slot_b + 32 * kk));
        }
        wgmma_commit();
        wgmma_wait<1>();   // the last slot's products are done
        if (s0 + u > 0 && lane == 0) mbar_arrive(slot_empty + 8 * ((u + kSlots - 1) % kSlots));
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the accumulator of m64nN: warp q of the warpgroup holds rows 16 q + g and
  // 16 q + g + 8, columns 8 j + 2 t and + 1 (g = lane / 4, t = lane % 4)
  const int g = lane / 4, t = lane % 4;
  const int ra = r0 + (tid / 32) % 4 * 16 + g, w2 = 2 * w;
  const int cb = c0 + wg * N + 2 * t;
  float* plane = out + b * h * static_cast<int64_t>(w2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = cb + 8 * j;
    if (c >= w2) break;
    if (ra < h) {
      *reinterpret_cast<float2*>(plane + static_cast<int64_t>(ra) * w2 + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    }
    if (ra + 8 < h) {
      *reinterpret_cast<float2*>(plane + static_cast<int64_t>(ra + 8) * w2 + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <bool kRaw, int N>
int launch(const int32_t* a, const int32_t* ys, const float* wpos, const float* wneg,
           float* out, int b, int n, int h, int w, int chunk, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = smem_bytes<N>(kRaw ? 4 : 2, chunk);
  if (b > 65535 || n < 0 || chunk <= 0 || chunk % kDepth != 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t opted = 48 * 1024;   // the attribute is per kernel: raise it as needed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        x1_wgmma_kernel<kRaw, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid((2 * w + 2 * N - 1) / (2 * N), (h + kRows - 1) / kRows, b);
  x1_wgmma_kernel<kRaw, N><<<grid, kThreads, smem, stream>>>(a, ys, wpos, wneg, out, n, h, w,
                                                             chunk);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRaw>
int launch_plan(const int32_t* a, const int32_t* ys, const float* wpos, const float* wneg,
                float* out, int b, int n, int h, int w, int chunk, int tile_n,
                cudaStream_t stream) {
  switch (tile_n) {
    case 96: return launch<kRaw, 96>(a, ys, wpos, wneg, out, b, n, h, w, chunk, stream);
    case 128: return launch<kRaw, 128>(a, ys, wpos, wneg, out, b, n, h, w, chunk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// X1a: xs, ys int32, wpos, wneg f32, all (b, n), 16-byte aligned; out (b, h,
// 2w) f32. tile_n (96 or 128): the columns of each warpgroup, the plan's.
extern "C" int mem_exp_voxelize_base(const int32_t* xs, const int32_t* ys, const float* wpos,
                                     const float* wneg, float* out, int b, int n, int h, int w,
                                     int chunk, int tile_n, cudaStream_t stream) {
  return launch_plan<true>(xs, ys, wpos, wneg, out, b, n, h, w, chunk, tile_n, stream);
}

// X1b: col, ys int32 (b, n), 16-byte aligned; out (b, h, 2w) f32. X1c is
// this launch with chunk = inner.
extern "C" int mem_exp_voxelize_fused_onehot(const int32_t* col, const int32_t* ys, float* out,
                                             int b, int n, int h, int w, int chunk, int tile_n,
                                             cudaStream_t stream) {
  return launch_plan<false>(col, ys, nullptr, nullptr, out, b, n, h, w, chunk, tile_n, stream);
}
