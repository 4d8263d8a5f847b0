// Hopper building blocks shared by the port's wgmma kernels (gemm.cu,
// c3_bottleneck.cu): mbarriers, TMA loads and their descriptors, and the
// warpgroup MMA (`wgmma.mma_async`, bf16 in, fp32 accumulator in registers)
// on 128-byte-swizzled shared-memory tiles.
//
// The tile layout both kernels use: a stage of the ring holds an A tile of
// BM rows x 64 k (K-major, one 128-byte swizzled row per A row) and BN / 64
// slabs of B, each 64 k x 64 n (N-major: B's rows are k), which wgmma takes
// for 16-bit types through the transpose bit of B. One producer warp fills
// the ring with TMA; BM / 64 consumer warpgroups each run 64 x BN of the
// tile. Every tile starts on a 1024-byte boundary (the swizzle atom).
//
// The TMA descriptors are encoded on the host with libcuda's
// cuTensorMapEncodeTiled, so a library that includes this links libcuda.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "cft_common.cuh"

namespace cft {

constexpr int kBK = 64;         // k per stage: one 128-byte swizzle row of A
constexpr int kSwizzle = 1024;  // bytes of one 8-row 128-byte swizzle atom
constexpr int kMaxDevices = 64;  // per-device launch set-up is cached below

// a BM x BN block tile with a ring of STAGES stages
template <int BM, int BN, int STAGES>
struct TileShape {
  static constexpr int kConsumers = BM / 64;          // warpgroups
  static constexpr int kThreads = 128 * kConsumers + 32;  // + producer warp
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBK * BN * 2;
  // the ring, its 2 * STAGES barriers, and slack to align the ring to 1024
  static constexpr int kSmem = STAGES * kStageBytes + 16 * STAGES + kSwizzle;
};

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// returns once the barrier's phase of parity `parity` has completed; traps
// (a launch failure, not a hang) if that takes more than about 10 seconds
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

// ----------------------------------------------------------------------- TMA
// the box at (c0 innermost, c1) of `map` into smem, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// the same for a 4-D map; coordinates may be negative or past the end, and
// the box's elements out there are zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// smem -> global: the box at (c0, .., c3) of `map` from `src`, clipped to
// the tensor; one bulk group per commit
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// makes this thread's shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of `threads` threads (a multiple of 32) under id 1..15
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a 2-D row-major bf16 matrix (outer x inner) as a TMA map of box_inner x
// box_outer tiles, 128-byte swizzle, zeros outside the matrix
inline bool tma_map(CUtensorMap* map, const void* base, int inner, int outer,
                    int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --------------------------------------------------------------------- wgmma
// shared-memory matrix descriptor, 128-byte swizzle. lbo: bytes between
// swizzle atoms along M/N (N-major B; unused for K-major A), sbo: bytes
// between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma_* calls
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x BN, fp32) += A (64 x 16, K-major) . B (16 x BN, N-major). The
// accumulator layout: warp w of the group holds rows 16w .. 16w+15;
// d[4j + 2h + e] is row lane/4 + 8h, column 8j + 2(lane%4) + e.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef ACC8

// ------------------------------------------------------------- the ring
// The ring at the start of dynamic shared memory, aligned to the swizzle
// atom, and its STAGES "full" and "empty" barriers after it. Thread 0 sets
// them up; every thread of the block must call this.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ unsigned char* ring_init(unsigned char* smem_raw,
                                                    uint64_t*& full,
                                                    uint64_t*& empty) {
  using S = TileShape<BM, BN, STAGES>;
  unsigned char* ring =
      smem_raw + ((kSwizzle - smem_u32(smem_raw) % kSwizzle) % kSwizzle);
  full = reinterpret_cast<uint64_t*>(ring + STAGES * S::kStageBytes);
  empty = full + STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], 4 * S::kConsumers);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// the producer's stage at ring position `it`: waits until the consumers have
// released it, arms its full barrier for a whole stage of bytes, returns it
template <int BM, int BN, int STAGES>
__device__ __forceinline__ unsigned char* next_stage(unsigned char* ring,
                                                     uint64_t* full,
                                                     uint64_t* empty, int it) {
  using S = TileShape<BM, BN, STAGES>;
  const int s = it % STAGES;
  mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // round 0 passes
  mbar_expect_tx(&full[s], S::kStageBytes);
  return ring + s * S::kStageBytes;
}

// the consumers' main loop over one tile's KT stages of the ring, starting
// at ring position `it` (advanced past them): acc (64 x BN of warpgroup wg)
// = A . B over the tile's k, each stage released once its products are done
template <int BM, int BN, int STAGES>
__device__ __forceinline__ void consume_tile(float (&acc)[BN / 2],
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int KT, int& it, int wg,
                                             int lane) {
  using S = TileShape<BM, BN, STAGES>;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned a_s = smem_u32(ring + s * S::kStageBytes) + wg * 64 * 128;
    const unsigned b_s = smem_u32(ring + s * S::kStageBytes + S::kABytes);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      // A: +32 bytes per 16 k inside the swizzled 128-byte rows; B: +16 rows
      wgmma_bf16<BN>(acc, wgmma_desc(a_s + kk * 32, 16, kSwizzle),
                     wgmma_desc(b_s + kk * 16 * 128, kBK * 128, kSwizzle));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
}

}  // namespace cft
