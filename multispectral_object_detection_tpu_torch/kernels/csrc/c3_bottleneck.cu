// Fused C3 bottleneck of the YOLOv5 backbone and neck, BN folded, NHWC:
//     z = SiLU(x . W1 + b1)                  1x1 conv, rounded to the dtype
//     y = x + SiLU(conv3x3(z, W2) + b2)      z zero-padded, residual in fp32
//
// Replaces the TPU kernel `_kernel` of multispectral_object_detection_tpu/
// ops/pallas_c3.py (bottleneck_pallas). That kernel keeps one image's padded
// 1x1 output in VMEM: 3.3 MB at P2 of the l model, where an SM has 227 KB.
// Here a bottleneck is two launches of one implicit-GEMM kernel over the
// P = B*H*W pixels:
//   1. TAPS = 1: the 1x1 as a (P, C) x (C, C) GEMM; epilogue bias + SiLU;
//      z is written to device memory, rounded to the dtype as `_kernel`
//      rounds it into its scratch;
//   2. TAPS = 9: the 3x3 as a GEMM of depth 9*C. The A tile of tap (dy, dx)
//      holds, for each output pixel, z at the pixel shifted by (dy-1, dx-1),
//      or zeros where that falls outside the image: the padding is of z after
//      its SiLU, as `_kernel` zeroes its pad columns after the SiLU. The
//      epilogue adds the bias, applies SiLU, adds the residual x in fp32 and
//      rounds once.
// W is (TAPS, C, N) row-major: W1 as (in, out), W2 as HWIO (3, 3, in, out).
// Biases are fp32 or bf16 (stored bf16 after the inference cast) and widened.
//
// Bound: operations for the fused function at the l model's shapes (20*P*C^2
// operations against 4*P*C bytes of x and y: 5*C operations per byte, >= 320
// at C >= 64). This two-launch design also writes z and reads it back, which
// makes the 1x1 at C = 64 bytes-bound. Design:
//   - bf16: the ring of hopper.cuh (shared with gemm.cu): one producer warp
//     keeps TMA loads in flight into a ring of stages with full/empty
//     mbarriers; BM / 64 consumer warpgroups run wgmma.mma_async m64nNk16
//     on them, fp32 accumulator in registers. A warpgroup's 64 rows are an
//     8 x 8 pixel box of one image (a "quantum"); a block tile is BM / 64
//     consecutive quanta by BN output channels. Every stage's H and W at
//     the l@640 and x@1024 bench sizes are multiples of 8; TTA's 544 and
//     448 px passes are not at 68, 34 and 28 px: their ragged last boxes
//     compute 12 %, 38 % and 31 % more pixel rows than the image has.
//     A k-step is one tap and 64 input channels. The A tile of tap (dy, dx)
//     is one TMA box per quantum from a 4-D map of the input over (C, W, H,
//     B): 64 channels x 8 x 8 pixels x 1 image at (c0, w0 + dx - 1, h0 + dy
//     - 1, b). TMA fills the box's elements outside the image with zeros,
//     negative coordinates included: that is the 3x3's zero padding, and the
//     rows of a ragged edge. With the 128-byte swizzle the box lands in
//     shared memory as the K-major swizzled A tile that wgmma reads. W comes
//     as in gemm.cu: 64-column slabs of the 2-D (TAPS*C, N) map through
//     wgmma's transpose bit, zeros past N. The kernel is persistent: a block
//     walks tiles (grid = resident blocks), and the producer runs ahead
//     across tiles, so the next tile's loads overlap this one's epilogue
//     (the 1x1 at C = 64 is one k-step per tile). The epilogue widens the
//     bias and applies SiLU on the accumulator registers, then goes through
//     a staging tile in shared memory laid out as TMA boxes: the 3x3's
//     residual arrives there by TMA (requested before the tile's main
//     loop), and the result leaves by TMA stores, which clip what lies
//     outside the image and past N. (Stores of two channels a thread from
//     the registers held the 1x1s near 40 % of the memory rate.) Tiles by
//     launch from timing on the card: see `launch_picked`. Each tap loads its
//     box anew (9 times z's bytes from L2), so the 3x3 moves about 5 TB/s
//     from L2 into shared memory at the rates measured, near what the card
//     gives: the likely bound of this design.
//   - fp32: true fp32 FMA on the CUDA cores (no TF32), a 64x64 tile with 4x4
//     outputs per thread, because the reference it is held against is a
//     full-precision fp32 convolution. Used only by the checks.
#include "hopper.cuh"

using namespace cft;

namespace {

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float bias_at(const void* b, int bias_bf16, int n) {
  return bias_bf16 ? to_float(static_cast<const bf16*>(b)[n])
                   : static_cast<const float*>(b)[n];
}

// ---------------------------------------------------------------- bf16 path
// SiLU on the fast exponential and reciprocal, for the epilogue's every
// element: a few fp32 ulps from silu(), far below the bf16 rounding that
// follows; 0 where exp(-v) overflows.
__device__ __forceinline__ float fast_silu(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// bias[n] and bias[n + 1] (n even), widened
__device__ __forceinline__ float2 bias2_at(const void* b, int bias_bf16,
                                           int n) {
  return bias_bf16 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                         static_cast<const bf16*>(b) + n))
                   : *reinterpret_cast<const float2*>(
                         static_cast<const float*>(b) + n);
}

constexpr int kQ = 8;                 // a quantum is kQ x kQ pixels
constexpr int kBoxBytes = 64 * kBK * 2;  // its A box: 64 rows of 64 channels

// the quanta of a (B, H, W) batch and the tiles over them: tile t is BM / 64
// quanta from quantum (t / tiles_n) * BM / 64 on, by BN output channels from
// (t % tiles_n) * BN on; quantum q is in image q / per_image, at quantum row
// (q % per_image) / across and column (q % per_image) % across
struct Tiling {
  int B, H, W, C, N;
  int across, per_image;  // quanta across an image, in an image
  int tiles_n, tiles;
};

template <int BM, int BN>
Tiling tiling(int B, int H, int W, int C, int N) {
  Tiling g{B, H, W, C, N};
  g.across = (W + kQ - 1) / kQ;
  g.per_image = ((H + kQ - 1) / kQ) * g.across;
  const long long quanta = (long long)B * g.per_image;
  g.tiles_n = (N + BN - 1) / BN;
  g.tiles = (int)((quanta + BM / 64 - 1) / (BM / 64)) * g.tiles_n;
  return g;
}

// shared memory of a block: the ring, its barriers, the staging tiles
template <int BM, int BN, int STAGES>
constexpr int conv_smem() {
  // the ring ends on a swizzle atom; the barriers take the next 1024 bytes,
  // the staging tiles (BM x BN bf16, swizzled boxes) follow
  return TileShape<BM, BN, STAGES>::kSmem + kSwizzle + BM * BN * 2;
}

// grid: resident blocks, at most one per tile; each walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
template <int TAPS, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(TileShape<BM, BN, STAGES>::kThreads)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_res,
                      const __grid_constant__ CUtensorMap map_out,
                      const void* __restrict__ bias, int bias_bf16,
                      const Tiling g) {
  using S = TileShape<BM, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  uint64_t *full, *empty;
  unsigned char* ring = ring_init<BM, BN, STAGES>(smem_raw, full, empty);
  uint64_t* res_full = empty + STAGES;  // one per warpgroup
  unsigned char* staging = ring + STAGES * S::kStageBytes + kSwizzle;
  if (threadIdx.x < S::kConsumers) {
    mbar_init(&res_full[threadIdx.x], 1);  // the leader's expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KT = TAPS * g.C / kBK;  // k-steps: a tap and 64 channels each

  if (warp == 4 * S::kConsumers) {
    // producer: one lane keeps the ring full, across tiles. Per stage it
    // only starts the TMA copies (a stage of the 3x3 at C = 64 is a few
    // hundred cycles of MMA): each quantum's origin is worked out once per
    // tile, and taps and slabs are counted, not divided out.
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const int n0 = (t % g.tiles_n) * BN;
        int qw[S::kConsumers], qh[S::kConsumers], qb[S::kConsumers];
#pragma unroll
        for (int i = 0; i < S::kConsumers; ++i) {
          // a quantum past the last image (b >= B) loads zeros
          const int q = (t / g.tiles_n) * S::kConsumers + i;
          const int r = q % g.per_image;
          qb[i] = q / g.per_image;
          qh[i] = (r / g.across) * kQ - (TAPS == 9);
          qw[i] = (r % g.across) * kQ - (TAPS == 9);
        }
        for (int tap = 0; tap < TAPS; ++tap) {
          const int dy = tap / 3, dx = tap % 3;  // shifts from (-1, -1)
          for (int c0 = 0; c0 < g.C; c0 += kBK, ++it) {
            unsigned char* st =
                next_stage<BM, BN, STAGES>(ring, full, empty, it);
            uint64_t* bar = &full[it % STAGES];
#pragma unroll
            for (int i = 0; i < S::kConsumers; ++i)
              tma_load_4d(st + i * kBoxBytes, &map_x, bar, c0, qw[i] + dx,
                          qh[i] + dy, qb[i]);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)  // 64-column slabs of W
              tma_load_2d(st + S::kABytes + j * kBK * 128, &map_w, bar,
                          n0 + 64 * j, tap * g.C + c0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes quantum wg of the tile. Its output
  // goes through a staging tile in shared memory, BN / 64 boxes of 64
  // channels x 8 x 8 pixels laid out as TMA's 128-byte swizzle lays them
  // out, and leaves as TMA stores, which clip what lies outside the image
  // and past N. For the 3x3, the residual comes into the same boxes by TMA,
  // requested before the tile's main loop.
  const int wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* stg = staging + wg * (BN / 64) * kBoxBytes;
  int it = 0;
  unsigned res_phase = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const int q = (t / g.tiles_n) * S::kConsumers + wg;
    const int b = q / g.per_image, r = q % g.per_image;
    const int w0 = (r % g.across) * kQ, h0 = (r / g.across) * kQ;
    const int n0 = (t % g.tiles_n) * BN;
    if (leader) {
      bulk_wait_read();  // the last tile's stores are done with stg
      if constexpr (TAPS == 9) {
        mbar_expect_tx(&res_full[wg], BN * kBoxBytes / 64);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_4d(stg + j * kBoxBytes, &map_res, &res_full[wg],
                      n0 + 64 * j, w0, h0, b);
      }
    }
    __syncwarp();  // wgmma wants the warp converged after the last epilogue
    float acc[BN / 2];
    consume_tile<BM, BN, STAGES>(acc, ring, full, empty, KT, it, wg, lane);
    if constexpr (TAPS == 9) {
      mbar_wait(&res_full[wg], res_phase);
      res_phase ^= 1;
    } else {
      named_barrier(1 + wg, 128);  // the leader has seen stg free
    }

    // rows of acc (see wgmma_bf16): this thread's are box rows row and
    // row + 8; its two channels of column block j are 16-byte chunk j % 8
    // of box j / 8, which the swizzle moves to chunk (j % 8) ^ (row % 8)
    const int row = (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= g.N) continue;
      const float2 bv = bias2_at(bias, bias_bf16, n);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            stg + (j / 8) * kBoxBytes + (row + 8 * hh) * 128 +
            (((j % 8) ^ (lane / 4)) << 4) + 4 * (lane % 4));
        float y0 = fast_silu(acc[4 * j + 2 * hh] + bv.x);
        float y1 = fast_silu(acc[4 * j + 2 * hh + 1] + bv.y);
        if constexpr (TAPS == 9) {
          const float2 rv = __bfloat1622float2(*p);
          y0 = rv.x + y0;
          y1 = rv.y + y1;
        }
        *p = __floats2bfloat162_rn(y0, y1);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (leader) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        if (n0 + 64 * j < g.N)
          tma_store_4d(&map_out, stg + j * kBoxBytes, n0 + 64 * j, w0, h0, b);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read();  // stg stays until the stores have read it
}

// x (B, H, W, C) NHWC bf16 as a 4-D TMA map (C innermost, W, H, B) of boxes
// of 64 channels x kQ x kQ pixels x 1 image, 128-byte swizzle, zeros outside
bool tma_map_nhwc(CUtensorMap* map, const void* base, int B, int H, int W,
                  int C) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBK, kQ, kQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TAPS, int BM, int BN, int STAGES>
cudaError_t launch_bf16(const bf16* X, const bf16* Wt, const void* bias,
                        int bias_bf16, const bf16* res, bf16* out, int B,
                        int H, int W, int C, int N, int dev, cudaStream_t s) {
  using S = TileShape<BM, BN, STAGES>;
  constexpr int smem = conv_smem<BM, BN, STAGES>();
  CUtensorMap map_x, map_w, map_res, map_out;
  if (!tma_map_nhwc(&map_x, X, B, H, W, C) ||
      !tma_map(&map_w, Wt, N, TAPS * C, 64, kBK) ||
      !tma_map_nhwc(&map_out, out, B, H, W, N) ||
      !tma_map_nhwc(&map_res, TAPS == 9 ? res : out, B, H, W, N))
    return cudaErrorInvalidValue;
  auto kernel = conv_wgmma_kernel<TAPS, BM, BN, STAGES>;
  // blocks resident on an SM; the launch's shared-memory attribute (refused
  // above the default 48 KB without it) is set once per device
  static int resident[kMaxDevices] = {};
  int per_sm = dev < kMaxDevices ? resident[dev] : 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    if (dev < kMaxDevices) resident[dev] = per_sm;
  }
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Tiling g = tiling<BM, BN>(B, H, W, C, N);
  const int grid = g.tiles < per_sm * sms ? g.tiles : per_sm * sms;
  kernel<<<grid, S::kThreads, smem, s>>>(map_x, map_w, map_res, map_out, bias,
                                         bias_bf16, g);
  return cudaSuccess;
}

// The tile of a launch (BM x BN, ring stages: shared memory, blocks an SM),
// from timing six tiles on an H100 at the l@640 and x@1024 shapes: 128 x 64
// for every 1x1 (they are bytes-bound; two blocks an SM overlap one's
// epilogue with the other's loads) and for the 3x3 at N = 64; for the 3x3,
// 128 x 128 at N = 128, and 256 x 128 from N = 256 on (W's slab is shared by
// 256 rows, which halves its L2 traffic per operation). N = 192 takes
// 128 x 64 (128 x 128 would compute a quarter of zeros).
template <int TAPS>
cudaError_t launch_picked(const bf16* X, const bf16* Wt, const void* bias,
                          int bias_bf16, const bf16* res, bf16* out, int B,
                          int H, int W, int C, int N, int dev, cudaStream_t s) {
#define C3_LAUNCH(BM, BN, STAGES)                                         \
  launch_bf16<TAPS, BM, BN, STAGES>(X, Wt, bias, bias_bf16, res, out, B, H, \
                                    W, C, N, dev, s)
  if constexpr (TAPS == 1) {
    return C3_LAUNCH(128, 64, 3);  // 91 KB, 2 blocks an SM
  } else {
    if (N < 256 && N % 128) return C3_LAUNCH(128, 64, 3);
    if (N < 256) return C3_LAUNCH(128, 128, 4);  // 163 KB, 1
    return C3_LAUNCH(256, 128, 3);               // 211 KB, 1
  }
#undef C3_LAUNCH
}

// ---------------------------------------------------------------- fp32 path
constexpr int kThreads = 256;

template <int TAPS>
__global__ void __launch_bounds__(kThreads)
    conv_f32_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                    const void* __restrict__ bias, int bias_bf16,
                    const float* __restrict__ res, float* __restrict__ out,
                    int P, int H, int W, int C, int N) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];  // A tile stored k-major
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this thread's A row and channel quad (fixed over the K loop)
  const int ar = tid / 4, akc = (tid % 4) * 4;
  const int p = m0 + ar, hw = p % (H * W);
  const int h = p < P ? hw / W : -1, w = hw % W;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < TAPS * C; k0 += BK) {
    const int tap = k0 / C, c0 = k0 - tap * C;
    {
      // the source pixel of tap (dy, dx), or padding
      const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
      const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
      const bool in = h >= 0 && (unsigned)(h + dy) < (unsigned)H &&
                      (unsigned)(w + dx) < (unsigned)W;
      const long long src = (long long)p + dy * W + dx;
      const float4 a =
          in ? *reinterpret_cast<const float4*>(A + src * C + c0 + akc)
             : make_float4(0.f, 0.f, 0.f, 0.f);
      As[akc + 0][ar] = a.x;
      As[akc + 1][ar] = a.y;
      As[akc + 2][ar] = a.z;
      As[akc + 3][ar] = a.w;
    }
    {
      const int r = tid / 16, nc = (tid % 16) * 4;
      const float4 b =
          *reinterpret_cast<const float4*>(Wt + (size_t)(k0 + r) * N + n0 + nc);
      Bs[r][nc + 0] = b.x;
      Bs[r][nc + 1] = b.y;
      Bs[r][nc + 2] = b.z;
      Bs[r][nc + 3] = b.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      const size_t idx = (size_t)m * N + n;
      float y = silu(acc[i][j] + bias_at(bias, bias_bf16, n));
      if constexpr (TAPS == 9) y = res[idx] + y;
      out[idx] = y;
    }
  }
}

template <int TAPS>
int launch(const void* a, const void* w, const void* bias, int bias_bf16,
           const void* res, void* out, int B, int H, int W, int C, int N,
           int dtype, cudaStream_t s) {
  if (dtype == kBFloat16) {
    int dev = 0;
    cudaGetDevice(&dev);
    const cudaError_t e = launch_picked<TAPS>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), bias,
        bias_bf16, static_cast<const bf16*>(res), static_cast<bf16*>(out), B,
        H, W, C, N, dev, s);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == kFloat32) {
    const int P = B * H * W;
    conv_f32_kernel<TAPS><<<dim3((P + 63) / 64, N / 64), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), bias,
        bias_bf16, static_cast<const float*>(res), static_cast<float*>(out),
        P, H, W, C, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One of the bottleneck's two convolutions over x (B, H, W, C) NHWC in
// `dtype`: taps = 1 is the 1x1 with w (C, N) and no residual (res null);
// taps = 9 is the 3x3 with w (9, C, N), zero padding 1 and the residual res
// (B, H, W, N), N == C. bias (N,) is fp32, or bf16 when bias_bf16. out (B, H,
// W, N) in `dtype`. C % 64 == 0, N % 64 == 0, pointers 16-byte aligned
// (checked in Python).
extern "C" int c3_conv(const void* x, const void* w, const void* bias,
                       int bias_bf16, const void* res, void* out, int B, int H,
                       int W, int C, int N, int taps, int dtype,
                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || C % 64 || N % 64 ||
      (long long)B * H * W > (1LL << 31) - 256)  // pixel indices are ints
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 1 && res == nullptr)
    return launch<1>(x, w, bias, bias_bf16, res, out, B, H, W, C, N, dtype, s);
  if (taps == 9 && res != nullptr && N == C)
    return launch<9>(x, w, bias, bias_bf16, res, out, B, H, W, C, N, dtype, s);
  return (int)cudaErrorInvalidValue;
}
