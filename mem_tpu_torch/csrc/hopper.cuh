// Hopper building blocks of the long attention kernels: the forward
// (attention_long_fwd.cuh, K3f / K5b) and the backward
// (attention_long_bwd.cuh, K3b / K5d / K5e) include this file. mbarriers,
// TMA loads into shared memory, wgmma on tiles of 64 rows of one head's D
// bf16 columns, written by TMA with the swizzle of their row width, the
// accumulator layout's helpers, and the host side's tensor-map encoding.
//
// The head dim D is a template argument of everything that depends on it.
// D = 64 (the ViT-B trunk, the seg backbone): 128-byte rows, 128 B swizzle,
// 8 KB tiles. D = 32 (the MAE decoder's 16 heads of 512): 64-byte rows, 64 B
// swizzle, 4 KB tiles. A tile is a box of a 3-D tensor map over (columns,
// rows, planes), planes being samples (flat (B, N, H*D) layouts) or (sample,
// head) pairs (head-major (B, H, N, D)).

#pragma once

#include <cstdint>
#include <cuda.h>   // CUtensorMap and its enums (the types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWgTile = 64;                       // rows of a tile: wgmma's m
// the head dims the wgmma paths take
constexpr bool wgmma_head_dim(int d) { return d == 64 || d == 32; }
// a Q, K, V or dO tile: 64 rows of 2D bytes
template <int D>
constexpr int kTileBytes = kWgTile * D * 2;
// K / V ring stages of the forward and backward blocks: 3 at D = 64, 2 at
// D = 32 (measured at the MAE decoder's shape: the note on D = 32 in
// attention_long_fwd.cuh)
template <int D>
constexpr int kRingStages = D == 64 ? 3 : 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory, counted on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ``bytes`` contiguous bytes of device memory into shared memory, counted on
// ``bar``; both addresses and the size multiples of 16
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// one box of shared memory to a 3-D tensor map: an asynchronous bulk store,
// committed with bulk_commit; what lies outside the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most kPending committed bulk stores still read shared memory
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kPending) : "memory");
}

// until at most kPending committed bulk stores are still incomplete
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" :: "n"(kPending) : "memory");
}

// makes this thread's shared-memory writes visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a barrier of ``threads`` threads (a warpgroup: 128) on barrier ``id`` (> 0)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// A shared-memory matrix descriptor for a tile of 128-byte rows written by
// TMA with 128 B swizzle: 8-row groups 1024 B apart (SBO), layout 1 (128 B
// swizzle). The leading byte offset (1) is read by neither operand form here:
// a K-major k16 slice and an MN-major n64 slice each lie inside one swizzle
// atom of 128 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// The descriptor of a tile of 2D-byte rows: D = 64 sw128_desc; D = 32 a tile
// written by TMA with 64 B swizzle, 8-row groups 512 B apart (SBO), layout 2
// (64 B swizzle). Again no operand form here reads the leading byte offset: a
// K-major k16 slice (32 B) and the MN-major n32 slice (64 B) each lie inside
// one 64-byte swizzle row.
template <int D>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  static_assert(D == 64 || D == 32, "the wgmma head dims");
  if constexpr (D == 64) {
    return sw128_desc(addr);
  } else {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
           (uint64_t{512 >> 4} << 32) | (uint64_t{2} << 62);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// keeps A fragments in their registers until the product that reads them
// has completed
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
  }
}

#define MEM_WG_D32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define MEM_WG_W32(d)                                                                        \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),     \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),           \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),        \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),        \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),        \
      "=f"(d[31])
#define MEM_WG_D16(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define MEM_WG_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MEM_WG_R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
// a 64-register accumulator: two 32-register arrays, operands %0 - %63
#define MEM_WG_R64                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (+)= a b, a and b K-major tiles in shared memory; ``acc`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MEM_WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MEM_WG_D32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d = a b as wgmma_ss with ``acc`` 0, d only written: its old values are
// dead, so the compiler keeps nothing in its registers for it (moving a
// value into an accumulator while an earlier product is in flight would make
// ptxas serialize the products)
__device__ __forceinline__ void wgmma_ss_fresh(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MEM_WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MEM_WG_W32(d)
      : "l"(a), "l"(b), "r"(0));
}

// d (+)= a b, a in registers (the m16k16 fragment of each warp's 16 rows), b
// an MN-major tile in shared memory; ``acc`` 0 overwrites d
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MEM_WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MEM_WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// wgmma_rs_mn in the m64n32k16 form: d holds the 32 columns of an n32
// accumulator, 16 registers in the m64n64 layout's first four 8-column groups
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MEM_WG_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : MEM_WG_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (+)= a b over one k16 step in the m64n128k16 form: both operands in
// shared memory, K-major (kTrans 0) or MN-major (kTrans 1), the accumulator
// as two halves: lo holds columns 0-63 and hi columns 64-127, each in the
// m64n64 layout above (the n128 accumulator's registers 0-31 and 32-63);
// ``acc`` 0 overwrites d
template <int kTrans = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&lo)[32], float (&hi)[32], uint64_t a,
                                              uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MEM_WG_R64
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : MEM_WG_D32(lo), MEM_WG_D32(hi)
      : "l"(a), "l"(b), "r"(acc), "n"(kTrans));
}

// d = a b as wgmma_ss_n128 (K-major) with ``acc`` 0, both halves only
// written (as wgmma_ss_fresh)
__device__ __forceinline__ void wgmma_ss_n128_fresh(float (&lo)[32], float (&hi)[32], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MEM_WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MEM_WG_W32(lo), MEM_WG_W32(hi)
      : "l"(a), "l"(b), "r"(0));
}

#undef MEM_WG_D16
#undef MEM_WG_R16
#undef MEM_WG_D32
#undef MEM_WG_W32
#undef MEM_WG_R32
#undef MEM_WG_R64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// d = a b^T over the depth D of two K-major tiles (a: 64 rows of the
// product, b: its 64 columns): D / 16 k16 steps along the 2D-byte rows, 32
// bytes apart in the swizzle. Not committed.
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(d, sw_desc<D>(a + 32 * kk), sw_desc<D>(b + 32 * kk), kk);
  }
}

// wgmma_abt with d only written (wgmma_ss_fresh): for a product issued while
// an earlier one is still in flight
template <int D>
__device__ __forceinline__ void wgmma_abt_fresh(float (&d)[32], uint32_t a, uint32_t b) {
  wgmma_ss_fresh(d, sw_desc<D>(a), sw_desc<D>(b));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    wgmma_ss(d, sw_desc<D>(a + 32 * kk), sw_desc<D>(b + 32 * kk), 1);
  }
}

// d (+)= a b over a depth of 64 rows of b: a as the registers' A fragments of
// four k16 steps, b a tile read MN-major (its D columns contiguous; the
// descriptor's transpose bit reads it as it lies), k16 steps 16 rows of 2D
// bytes apart; the n64 form at D = 64, n32 at D = 32 (d: D / 2 registers);
// ``acc`` 0 overwrites d. Not committed.
template <int D>
__device__ __forceinline__ void wgmma_ab_mn(float (&d)[D / 2], const uint32_t (&a)[4][4],
                                            uint32_t b, int acc = 1) {
  wgmma_rs_mn(d, a[0], sw_desc<D>(b), acc);
#pragma unroll
  for (int kk = 1; kk < kWgTile / 16; ++kk) wgmma_rs_mn(d, a[kk], sw_desc<D>(b + 32 * D * kk));
}

// setmaxnreg: a warpgroup gives registers back to the block's pool (a
// producer) or takes them (a consumer); all its warps execute it together
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kRegs));
}

// The accumulator of m64n64 gives warp w of a warpgroup rows 16w + g and
// 16w + g + 8 (g = lane / 4) and, for j = 0..7, columns 8j + 2t, 8j + 2t + 1
// (t = lane % 4): d[4j], d[4j + 1] on the first row, d[4j + 2], d[4j + 3] on
// the second; m64n32 the same for j = 0..3. Two adjacent 8-column groups are
// the A fragment of one k16 step.
//
// The accumulator rounded to bf16 as the A fragments of four k16 steps
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    f[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    f[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    f[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// The bias of rows a and b (rows ga, gb of the head's bias) at this thread's
// 16 columns of the key tile at j0, in the accumulator's order; 0 past n.
__device__ __forceinline__ void load_bias(float (&bv)[32], const float* ga, const float* gb,
                                          int j0, int n, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = j0 + 8 * j + 2 * t + e;
      bv[4 * j + e] = key < n ? __ldg(ga + key) : 0.f;
      bv[4 * j + 2 + e] = key < n ? __ldg(gb + key) : 0.f;
    }
  }
}

// cuTensorMapEncodeTiled of the CUDA driver API, fetched through the runtime: no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 3-D map of one bf16 operand, boxes of 64 rows of one head's D columns,
// the swizzle of their row width (128 B at D = 64, 64 B at D = 32), zeros
// past n: flat (heads * D, n, b), head-major (D, n, b * heads).
template <int D>
cudaError_t tensor_map(EncodeTiled encode, CUtensorMap* map, const void* p, int b, int n,
                       int heads, bool head_major) {
  const cuuint64_t row = head_major ? D : static_cast<cuuint64_t>(heads) * D;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b) * (head_major ? heads : 1)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * n};   // bytes, dims 1 and 2
  const cuuint32_t box[3] = {D, kWgTile, 1}, step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
