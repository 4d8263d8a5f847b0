// GEMM with a fused epilogue for the CFT transformer stack:
//     out = epilogue(A (M, K) . W (K, N) + bias (N,))
// used four times per layer: QKV (bias), fc1 (bias + exact GELU), and the
// attention out-projection and fc2 (bias + in-place add into the fp32
// residual stream).
//
// Replaces the four jnp.dot calls and their bias/GELU/residual arithmetic in
// the TPU kernel `_kernel` of multispectral_object_detection_tpu/ops/
// pallas_fusion.py (fused_cft_stack). W keeps that kernel's (K, N) layout, so
// the stacked (L, K, N) weights are used as they are.
//
// Bound: operations at the main path's shapes (M = 2048 token rows, K and N
// from 256 to 4096: about 2*K*N*M / (2*(K*N + M*K + M*N)) >= 200 operations
// per byte in bf16), except proj and fc2 at C = 256, whose fp32 residual
// read and write make them bytes-bound. Design:
//   - bf16: Hopper's warpgroup MMA (`wgmma.mma_async` m64nNk16, bf16 in,
//     fp32 accumulator in registers) on tiles that the Tensor Memory
//     Accelerator (TMA) loads. One producer warp starts the TMA copies of an
//     A tile (BM x 64) and a W tile (64 x BN) into a ring of stages, each
//     tracked by a "full" and an "empty" mbarrier; BM / 64 consumer
//     warpgroups each run 64 x BN of the tile. Both tiles use the 128-byte
//     swizzle, set in the TMA descriptors and in the wgmma descriptors: A is
//     K-major, W is N-major (its rows are k), which wgmma takes for 16-bit
//     types through the transpose bit of B, so no relayout of W exists.
//     The block tile is 128x128 (3 stages, two blocks an SM), 128x64 or
//     64x64 (4 stages), the largest that gives enough blocks to fill the
//     card (proj and fc2 at C = 256 have 32 tiles of 128x128 and 128 of
//     64x64); the thresholds come from a sweep on the card. At 128x128 a
//     block loads 32 KB from L2 per 2.1 MFLOP. Two ways to cut that traffic
//     were measured slower at these shapes: 128x256 tiles (one block an SM,
//     too few blocks), and clusters of two blocks that multicast the W tile
//     (much slower as written). TMA fills zeros
//     outside the matrices (N = 960 and 320 at the x scale are not multiples
//     of 128, and any K tail), and the epilogue masks its stores. No split-K:
//     the residual epilogue adds into the stream in place, in one order.
//     The epilogue runs on the accumulator registers (two columns a store):
//     the bias widened from bf16, exact erff GELU, the residual as
//     (x + acc) + b in fp32.
//   - fp32: true fp32 FMA on the CUDA cores (no TF32), 64x64 block tile with
//     4x4 outputs per thread, because the reference it is held against is a
//     full-precision fp32 product. Used only by the checks.
// Rounding follows `_kernel`: the accumulator stays fp32, the bias is read in
// the compute dtype and widened, and the result is rounded once.
//
// The ring, TMA and wgmma helpers are shared with c3_bottleneck.cu
// (hopper.cuh). The TMA descriptors are built on the host per call with
// libcuda's cuTensorMapEncodeTiled, so this library links libcuda.
#include "hopper.cuh"

using namespace cft;

namespace {

enum Epilogue { kBias = 0, kGelu = 1, kResidual = 2 };

__device__ __forceinline__ float gelu(float t) {
  return t * 0.5f * (1.0f + erff(t * 0.70710678118654752440f));
}

template <typename T, int EPI>
__device__ __forceinline__ void epilogue_store(void* out, const T* bias, int N,
                                               int m, int n, float acc) {
  const float bv = to_float(bias[n]);
  const size_t idx = (size_t)m * N + n;
  if constexpr (EPI == kResidual) {
    float* o = static_cast<float*>(out);
    o[idx] = (o[idx] + acc) + bv;  // x = x + proj + b, as in `_kernel`
  } else {
    float t = acc + bv;
    if constexpr (EPI == kGelu) t = gelu(t);
    static_cast<T*>(out)[idx] = from_float<T>(t);
  }
}

// ---------------------------------------------------------------- bf16 path
// a BM x BN tile of out; grid (ceil(N / BN), ceil(M / BM))
template <int BM, int BN, int STAGES, int EPI>
__global__ void __launch_bounds__(TileShape<BM, BN, STAGES>::kThreads)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w,
                      const bf16* __restrict__ bias, void* out, int M, int N,
                      int K) {
  using S = TileShape<BM, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  uint64_t *full, *empty;
  unsigned char* ring = ring_init<BM, BN, STAGES>(smem_raw, full, empty);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + kBK - 1) / kBK;

  if (warp == 4 * S::kConsumers) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        unsigned char* st = next_stage<BM, BN, STAGES>(ring, full, empty, kt);
        uint64_t* bar = &full[kt % STAGES];
        tma_load_2d(st, &map_a, bar, kt * kBK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)  // 64-column slabs of W
          tma_load_2d(st + S::kABytes + j * kBK * 128, &map_w, bar,
                      n0 + 64 * j, kt * kBK);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes rows wg*64 .. wg*64+63 of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
  int it = 0;
  consume_tile<BM, BN, STAGES>(acc, ring, full, empty, KT, it, wg, lane);

  // rows of acc: see wgmma_bf16 (hopper.cuh)
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= N) continue;
    const float2 b2 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= M) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const size_t idx = (size_t)m * N + n;
      if constexpr (EPI == kResidual) {
        float2* o = reinterpret_cast<float2*>(static_cast<float*>(out) + idx);
        float2 x = *o;
        x.x = (x.x + v0) + b2.x;  // x = x + proj + b, as in `_kernel`
        x.y = (x.y + v1) + b2.y;
        *o = x;
      } else {
        float t0 = v0 + b2.x, t1 = v1 + b2.y;
        if constexpr (EPI == kGelu) {
          t0 = gelu(t0);
          t1 = gelu(t1);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) =
            __floats2bfloat162_rn(t0, t1);
      }
    }
  }
}

template <int BM, int BN, int STAGES, int EPI>
cudaError_t launch_bf16(const bf16* A, const bf16* W, const bf16* B, void* out,
                        int M, int N, int K, int dev, cudaStream_t s) {
  using S = TileShape<BM, BN, STAGES>;
  CUtensorMap map_a, map_w;
  if (!tma_map(&map_a, A, K, M, kBK, BM) || !tma_map(&map_w, W, N, K, 64, kBK))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<BM, BN, STAGES, EPI>;
  // without this the launch is refused above the default 48 KB; once per
  // device (a few microseconds of host time per call otherwise)
  static bool smem_set[kMaxDevices] = {};
  if (dev >= kMaxDevices || !smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }
  kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), S::kThreads, S::kSmem,
           s>>>(map_a, map_w, B, out, M, N, K);
  return cudaSuccess;
}

// ---------------------------------------------------------------- fp32 path
constexpr int kF32Threads = 256;

template <int EPI>
__global__ void __launch_bounds__(kF32Threads)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias, void* out, int M, int N,
                    int K) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];  // A tile stored k-major
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int r = tid / 4, kc = (tid % 4) * 4;
      const float4 a =
          *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + k0 + kc);
      As[kc + 0][r] = a.x;
      As[kc + 1][r] = a.y;
      As[kc + 2][r] = a.z;
      As[kc + 3][r] = a.w;
    }
    {
      const int r = tid / 16, nc = (tid % 16) * 4;
      const float4 b =
          *reinterpret_cast<const float4*>(W + (size_t)(k0 + r) * N + n0 + nc);
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epilogue_store<float, EPI>(out, bias, N, m0 + ty * 4 + i, n0 + tx * 4 + j,
                                 acc[i][j]);
}

int tiles(int M, int N, int bm, int bn) {
  return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

template <int EPI>
int launch(const void* a, const void* w, const void* bias, void* out, int M,
           int N, int K, int dtype, cudaStream_t s) {
  if (dtype == kBFloat16) {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* W = static_cast<const bf16*>(w);
    const bf16* B = static_cast<const bf16*>(bias);
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // from a sweep of the 24 GEMM shapes of the l@640 and x@1024 stages on
    // the card: 128x128 once it gives 1.35 blocks per SM (three stages, so
    // two blocks fit an SM), else 128x64 from 1.25 blocks per SM, else 64x64
    const cudaError_t e =
        tiles(M, N, 128, 128) * 20 >= sms * 27
            ? launch_bf16<128, 128, 3, EPI>(A, W, B, out, M, N, K, dev, s)
        : tiles(M, N, 128, 64) * 4 >= sms * 5
            ? launch_bf16<128, 64, 4, EPI>(A, W, B, out, M, N, K, dev, s)
            : launch_bf16<64, 64, 4, EPI>(A, W, B, out, M, N, K, dev, s);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == kFloat32) {
    gemm_f32_kernel<EPI><<<dim3(N / 64, M / 64), kF32Threads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w),
        static_cast<const float*>(bias), out, M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, K), w (K, N), bias (N,) in `dtype`; out (M, N) in `dtype`, or the fp32
// residual stream updated in place for the residual epilogue. M % 64 == 0,
// N % 64 == 0, K % 32 == 0, pointers 16-byte aligned (checked in Python).
extern "C" int cft_gemm(const void* a, const void* w, const void* bias,
                        void* out, int M, int N, int K, int epilogue, int dtype,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 64 || N % 64 || K % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBias:
      return launch<kBias>(a, w, bias, out, M, N, K, dtype, s);
    case kGelu:
      return launch<kGelu>(a, w, bias, out, M, N, K, dtype, s);
    case kResidual:
      return launch<kResidual>(a, w, bias, out, M, N, K, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
