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
// makes the C = 64 blocks bytes-bound. Design, kept simple for a first
// version (no TMA or wgmma):
//   - bf16: tensor cores through mma.sync.m16n8k16 with fp32 accumulation,
//     fragments loaded by ldmatrix from padded shared memory; a block tile
//     of 128 pixels x 128 output channels (8 warps of 64x32), or 128 x 64
//     (8 warps of 32x32) when N % 128 != 0; BK = 64 through a three-stage
//     cp.async ring (measured faster at every C than BK = 32 with four
//     stages, and than 4 warps of 64x64, which need 220 registers). The
//     shifted A rows are gathered by cp.async with a source size of 0 for
//     out-of-image taps and for rows past P, which fills zeros; each thread
//     works out its rows' (h, w) once. The epilogue works on the
//     accumulator fragments in place: two channels per store.
//   - fp32: true fp32 FMA on the CUDA cores (no TF32), a 64x64 tile with 4x4
//     outputs per thread, because the reference it is held against is a
//     full-precision fp32 convolution.
#include "cft_common.cuh"

using namespace cft;

namespace {

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float bias_at(const void* b, int bias_bf16, int n) {
  return bias_bf16 ? to_float(static_cast<const bf16*>(b)[n])
                   : static_cast<const float*>(b)[n];
}

// Row of A for pixel p and tap `tap` (0..8; dy = tap/3 - 1, dx = tap%3 - 1):
// the source pixel's offset in pixels, or -1 when the tap reads padding.
// h < 0 marks a row past P.
template <int TAPS>
__device__ __forceinline__ long long tap_source(int p, int h, int w, int tap,
                                                int H, int W) {
  if (h < 0) return -1;
  if constexpr (TAPS == 1) {
    return p;
  } else {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int hh = h + dy, ww = w + dx;
    if ((unsigned)hh >= (unsigned)H || (unsigned)ww >= (unsigned)W) return -1;
    return (long long)p + dy * W + dx;
  }
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBK = 64;     // K per pipeline step
constexpr int kStages = 3;  // cp.async ring depth
constexpr int kPad = 8;     // bf16 elements of row padding: rows 16 bytes past
                            // a multiple of 128, so ldmatrix's 8 rows hit 8
                            // different banks

template <int BM, int BN>
constexpr int bf16_smem_bytes() {
  return kStages * (BM * (kBK + kPad) + kBK * (BN + kPad)) * 2;
}

// BM pixels x BN output channels; a WARPS_M x WARPS_N grid of warps, each
// holding a (BM / WARPS_M) x (BN / WARPS_N) fp32 accumulator in registers
template <int TAPS, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    conv_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                     const void* __restrict__ bias, int bias_bf16,
                     const bf16* __restrict__ res, bf16* __restrict__ out,
                     int P, int H, int W, int C, int N) {
  constexpr int NT = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;     // m16 and n8 tiles per warp
  constexpr int LDA = kBK + kPad, LDB = BN + kPad;
  constexpr int CHUNKS = kBK / 8;               // 16-byte chunks per A row
  constexpr int A_ITERS = BM * CHUNKS / NT;    // A chunks per thread
  static_assert(NT % CHUNKS == 0 && (BM * CHUNKS) % NT == 0, "A tiling");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);        // kStages x BM x LDA
  bf16* Bs = As + kStages * BM * LDA;                   // kStages x kBK x LDB

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's A rows (fixed over the K loop) and their pixels' (h, w)
  const int kc = (tid % CHUNKS) * 8;
  int pix[A_ITERS], ph[A_ITERS], pw[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int p = m0 + (tid + i * NT) / CHUNKS;
    const int hw = p % (H * W);
    pix[i] = p;
    ph[i] = p < P ? hw / W : -1;
    pw[i] = hw % W;
  }

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int tap = k0 / C, c0 = k0 - tap * C;
    bf16* as = As + stage * BM * LDA;
    bf16* bs = Bs + stage * kBK * LDB;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int r = (tid + i * NT) / CHUNKS;
      const long long src = tap_source<TAPS>(pix[i], ph[i], pw[i], tap, H, W);
      cp_async16_zfill(as + r * LDA + kc,
                       src >= 0 ? A + src * C + c0 + kc : A, src >= 0);
    }
#pragma unroll
    for (int c = tid; c < kBK * BN / 8; c += NT) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      cp_async16(bs + r * LDB + nc, Wt + (size_t)(k0 + r) * N + n0 + nc);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int KT = TAPS * C / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_tile(st, st);
    cp_async_commit();  // one group per stage, empty or not
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; stage of kt - 1 is free
    const int nk = kt + kStages - 1;
    if (nk < KT) load_tile(nk % kStages, nk);
    cp_async_commit();
    const bf16* a_s = As + (kt % kStages) * BM * LDA + (wm * WM) * LDA;
    const bf16* b_s = Bs + (kt % kStages) * kBK * LDB + wn * WN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)  // lane -> row lane % 16, k half lane / 16
        ldmatrix_x4(af[i], a_s + (i * 16 + lane % 16) * LDA + kk +
                               (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {  // lane -> k row, n half lane / 16
        const int k = kk + lane % 8 + ((lane / 8) % 2) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, b_s + k * LDB + j * 8 + (lane / 16) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }

  // accumulator (i, j): rows g and g + 8 of the m16 tile, columns 2c, 2c + 1
  // of the n8 tile, g = lane / 4, c = lane % 4
  const int g = lane / 4, cq = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = n0 + wn * WN + j * 8 + cq;
    const float bv0 = bias_at(bias, bias_bf16, n);
    const float bv1 = bias_at(bias, bias_bf16, n + 1);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + i * 16 + g + h * 8;
        if (m >= P) continue;
        const size_t idx = (size_t)m * N + n;
        float y0 = silu(acc[i][j][2 * h] + bv0);
        float y1 = silu(acc[i][j][2 * h + 1] + bv1);
        if constexpr (TAPS == 9) {
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(res + idx);
          y0 = to_float(rv.x) + y0;
          y1 = to_float(rv.y) + y1;
        }
        __nv_bfloat162 o;
        o.x = from_float<bf16>(y0);
        o.y = from_float<bf16>(y1);
        *reinterpret_cast<__nv_bfloat162*>(out + idx) = o;
      }
    }
  }
}

template <int TAPS, int BM, int BN, int WARPS_M, int WARPS_N>
cudaError_t launch_bf16(const bf16* A, const bf16* Wt, const void* bias,
                        int bias_bf16, const bf16* res, bf16* out, int P,
                        int H, int W, int C, int N, cudaStream_t s) {
  constexpr int smem = bf16_smem_bytes<BM, BN>();
  auto kernel = conv_bf16_kernel<TAPS, BM, BN, WARPS_M, WARPS_N>;
  if (smem > 48 * 1024) {
    // without this the launch is refused above the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((P + BM - 1) / BM, N / BN), 32 * WARPS_M * WARPS_N, smem,
             s>>>(
      A, Wt, bias, bias_bf16, res, out, P, H, W, C, N);
  return cudaSuccess;
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
      const long long src = tap_source<TAPS>(p, h, w, tap, H, W);
      const float4 a =
          src >= 0 ? *reinterpret_cast<const float4*>(A + src * C + c0 + akc)
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
           const void* res, void* out, int P, int H, int W, int C, int N,
           int dtype, cudaStream_t s) {
  if (dtype == kBFloat16) {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* Wt = static_cast<const bf16*>(w);
    const bf16* R = static_cast<const bf16*>(res);
    bf16* O = static_cast<bf16*>(out);
    // 128 x 128 tiles of 8 warps of 64 x 32; 128 x 64 tiles of 8 warps of
    // 32 x 32 where N % 128 != 0
    const cudaError_t e =
        N % 128 == 0
            ? launch_bf16<TAPS, 128, 128, 2, 4>(A, Wt, bias, bias_bf16, R, O,
                                                P, H, W, C, N, s)
            : launch_bf16<TAPS, 128, 64, 4, 2>(A, Wt, bias, bias_bf16, R, O, P,
                                               H, W, C, N, s);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == kFloat32) {
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
  const int P = B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 1 && res == nullptr)
    return launch<1>(x, w, bias, bias_bf16, res, out, P, H, W, C, N, dtype, s);
  if (taps == 9 && res != nullptr && N == C)
    return launch<9>(x, w, bias, bias_bf16, res, out, P, H, W, C, N, dtype, s);
  return (int)cudaErrorInvalidValue;
}
