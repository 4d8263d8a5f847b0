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
// per byte in bf16). Design, kept simple for a first version:
//   - bf16: tensor cores through WMMA 16x16x16 tiles with fp32 accumulation;
//     a 128x128 block tile of 4 warps of 64x64 (64x64 of 4 warps of 32x32
//     when the large tile would leave most SMs idle); a warp tile's
//     fragment loads from shared memory, not the MMAs, set its pace,
//     BK = 32, a three-stage cp.async pipeline from device memory
//     into padded dynamic shared memory (64 KB at 128x128, so the launcher
//     raises the 48 KB default). The epilogue goes through a per-warp 16x16
//     fp32 scratch in shared memory; each lane then finishes 8 consecutive
//     columns with 16-byte loads and stores.
//   - fp32: true fp32 FMA on the CUDA cores (no TF32), 64x64 block tile with
//     4x4 outputs per thread, because the reference it is held against is a
//     full-precision fp32 product.
// Rounding follows `_kernel`: the accumulator stays fp32, the bias is read in
// the compute dtype and widened, and the result is rounded once.
#include <mma.h>

#include "cft_common.cuh"

using namespace nvcuda;
using namespace cft;

namespace {

enum Epilogue { kBias = 0, kGelu = 1, kResidual = 2 };

constexpr int kThreads = 256;

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
    if constexpr (EPI == kGelu)
      t = t * 0.5f * (1.0f + erff(t * 0.70710678118654752440f));
    static_cast<T*>(out)[idx] = from_float<T>(t);
  }
}

// 8 consecutive columns n..n+7 of row m (n % 8 == 0): 16-byte accesses
template <int EPI>
__device__ __forceinline__ void epilogue_store8(void* out, const bf16* bias,
                                                int N, int m, int n,
                                                const float* acc) {
  const uint4 braw = *reinterpret_cast<const uint4*>(bias + n);
  const bf16* bv = reinterpret_cast<const bf16*>(&braw);
  const size_t idx = (size_t)m * N + n;
  if constexpr (EPI == kResidual) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + idx);
    float x[8];
    *reinterpret_cast<float4*>(x) = o[0];
    *reinterpret_cast<float4*>(x + 4) = o[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = (x[i] + acc[i]) + to_float(bv[i]);
    o[0] = *reinterpret_cast<const float4*>(x);
    o[1] = *reinterpret_cast<const float4*>(x + 4);
  } else {
    uint4 packed;
    bf16* pk = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float t = acc[i] + to_float(bv[i]);
      if constexpr (EPI == kGelu)
        t = t * 0.5f * (1.0f + erff(t * 0.70710678118654752440f));
      pk[i] = from_float<bf16>(t);
    }
    *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + idx) = packed;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBK = 32;
constexpr int kPad = 8;     // bf16 elements of row padding (keeps 32-byte alignment)
constexpr int kStages = 3;  // cp.async pipeline depth

template <int BM, int BN, int WARPS>
constexpr int bf16_smem_bytes() {
  return kStages * (BM * (kBK + kPad) + kBK * (BN + kPad)) * 2 +
         WARPS * 16 * 16 * 4;
}

// BM x BN block tile over a WARPS_M x WARPS_N grid of warps
template <int BM, int BN, int WARPS_M, int WARPS_N, int EPI>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const bf16* __restrict__ bias, void* out, int M, int N,
                     int K) {
  constexpr int NT = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDA = kBK + kPad, LDB = BN + kPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);        // kStages x BM x LDA
  bf16* Bs = As + kStages * BM * LDA;                  // kStages x kBK x LDB
  float* Cs = reinterpret_cast<float*>(Bs + kStages * kBK * LDB);  // per warp 16x16

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * BM * LDA;
    bf16* bs = Bs + stage * kBK * LDB;
    for (int c = tid; c < BM * kBK / 8; c += NT) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      cp_async16(as + r * LDA + kc, A + (size_t)(m0 + r) * K + k0 + kc);
    }
    for (int c = tid; c < kBK * BN / 8; c += NT) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      cp_async16(bs + r * LDB + nc, W + (size_t)(k0 + r) * N + n0 + nc);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_tile(st, st * kBK);
    cp_async_commit();  // one group per stage, empty or not
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; stage of kt - 1 is free
    const int nk = kt + kStages - 1;
    if (nk < KT) load_tile(nk % kStages, nk * kBK);
    cp_async_commit();
    const bf16* a_s = As + (kt % kStages) * BM * LDA;
    const bf16* b_s = Bs + (kt % kStages) * kBK * LDB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_s + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], b_s + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }

  float* cs = Cs + warp * 16 * 16;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      // lane -> row lane / 2, columns (lane % 2) * 8 .. + 7 of the 16x16 tile
      const int r = lane / 2, c0 = (lane % 2) * 8;
      float v[8];
      *reinterpret_cast<float4*>(v) =
          *reinterpret_cast<const float4*>(cs + r * 16 + c0);
      *reinterpret_cast<float4*>(v + 4) =
          *reinterpret_cast<const float4*>(cs + r * 16 + c0 + 4);
      epilogue_store8<EPI>(out, bias, N, m0 + wm * WM + i * 16 + r,
                           n0 + wn * WN + j * 16 + c0, v);
      __syncwarp();
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int EPI>
cudaError_t launch_bf16(const bf16* A, const bf16* W, const bf16* B, void* out,
                        int M, int N, int K, cudaStream_t s) {
  constexpr int smem = bf16_smem_bytes<BM, BN, WARPS_M * WARPS_N>();
  auto kernel = gemm_bf16_kernel<BM, BN, WARPS_M, WARPS_N, EPI>;
  if (smem > 48 * 1024) {
    // without this the launch is refused above the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(N / BN, M / BM), 32 * WARPS_M * WARPS_N, smem, s>>>(
      A, W, B, out, M, N, K);
  return cudaSuccess;
}

// ---------------------------------------------------------------- fp32 path
template <int EPI>
__global__ void __launch_bounds__(kThreads)
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

template <int EPI>
int launch(const void* a, const void* w, const void* bias, void* out, int M,
           int N, int K, int dtype, cudaStream_t s) {
  if (dtype == kBFloat16) {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* W = static_cast<const bf16*>(w);
    const bf16* B = static_cast<const bf16*>(bias);
    // the large tile (4 warps of 64x64) unless it leaves most SMs idle;
    // then 64x64 tiles of 4 warps of 32x32
    const cudaError_t e =
        (M % 128 == 0 && N % 128 == 0 && (M / 128) * (N / 128) >= 100)
            ? launch_bf16<128, 128, 2, 2, EPI>(A, W, B, out, M, N, K, s)
            : launch_bf16<64, 64, 2, 2, EPI>(A, W, B, out, M, N, K, s);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == kFloat32) {
    gemm_f32_kernel<EPI><<<dim3(N / 64, M / 64), kThreads, 0, s>>>(
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
