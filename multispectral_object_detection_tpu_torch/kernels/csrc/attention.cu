// Per-(image, head) softmax attention of the CFT transformer stack:
//     o = softmax(Q K^T / sqrt(D)) V     over the N = 128 tokens of one image
//
// Replaces the static (image, head) loop of the TPU kernel `_kernel` in
// multispectral_object_detection_tpu/ops/pallas_fusion.py (fused_cft_stack).
//
// Bound: bytes. Each (image, head) reads 3*N*D values and writes N*D, and
// does 4*N*N*D operations: at N = 128 that is about 100 operations per
// byte in bf16, under the card's ridge. Design: one block of 8 warps per
// (image, head). K and V of the head are widened to fp32 once into shared
// memory (K rows padded to D + 1 floats so that lanes reading different keys
// hit different banks). A warp takes ROWS query rows at a time (8 up to
// D = 128) and keeps their scores in registers: a lane scores 4 keys for all
// ROWS rows, so each K value it loads from shared memory feeds ROWS FMAs (one
// load per FMA was the limit of a one-row-at-a-time design). The warp
// reduces max and sum with shuffles, and the probabilities go through shared
// memory to the P.V product, where a lane owns ceil(D/32) of the D columns
// for the same rows (a template parameter, so no FMA runs on an absent
// column). One block per SM leaves few warps to hide latency, so the loops
// are unrolled to keep several loads in flight. At D = 128 the shared memory
// is about 197 KB, above the 48 KB default, so the launcher raises the
// kernel's dynamic shared-memory limit first. Above D = 128 (the x scale's
// P5 stage, D = 160) 8 rows per warp would need 238,080 bytes, more than the
// 232,448 a block may have, so there a warp takes 4 rows (201,216 bytes).
// Rounding follows `_kernel`: fp32 logits and softmax, the probabilities
// rounded to the compute dtype, P.V accumulated in fp32, the result rounded.
#include "cft_common.cuh"

using namespace cft;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTokens = 128;
constexpr int kKeysPerLane = kMaxTokens / 32;
constexpr int kMaxCpl = 5;  // D <= 160

// CPL = ceil(D / 32): the D columns a lane owns in P.V; ROWS: the query rows
// a warp works on at once
template <typename T, int CPL, int ROWS>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N,
                     int C, int H) {
  const int D = C / H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ float smem[];
  float* Ks = smem;                     // N x (D + 1)
  float* Vs = Ks + N * (D + 1);         // N x D
  float* Qs = Vs + N * D;               // kWarps x ROWS x D
  float* Ps = Qs + kWarps * ROWS * D;  // kWarps x ROWS x N

  const size_t ld = 3 * (size_t)C;  // qkv row: [q (C) | k (C) | v (C)]
  const T* base = qkv + (size_t)b * N * ld;
#pragma unroll 8
  for (int e = tid; e < N * D; e += kThreads) {  // unrolled: loads in flight
    const int j = e / D, d = e % D;
    Ks[j * (D + 1) + d] = to_float(base[j * ld + C + h * D + d]);
    Vs[j * D + d] = to_float(base[j * ld + 2 * C + h * D + d]);
  }
  __syncthreads();

  const float sqrt_d = sqrtf((float)D);
  float* q = Qs + warp * ROWS * D;
  float* p = Ps + warp * ROWS * N;
  for (int i0 = warp * ROWS; i0 < N; i0 += kWarps * ROWS) {
    for (int e = lane; e < ROWS * D; e += 32) {
      const int i = i0 + e / D;
      q[e] = i < N ? to_float(base[i * ld + h * D + e % D]) : 0.f;
    }
    __syncwarp();

    // scores: s[r][t] = q_r . k_(lane + 32 t)
    float s[ROWS][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) s[r][t] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kKeysPerLane];
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        kv[t] = j < N ? Ks[j * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = q[r * D + d];
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t)
          s[r][t] = fmaf(qv, kv[t], s[r][t]);
      }
    }

    // softmax per row, probabilities rounded to the compute dtype
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        if (lane + 32 * t < N) {
          s[r][t] = s[r][t] / sqrt_d;
          mx = fmaxf(mx, s[r][t]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        if (lane + 32 * t < N) {
          s[r][t] = expf(s[r][t] - mx);
          sum += s[r][t];
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < N) p[r * N + j] = to_float(from_float<T>(s[r][t] / sum));
      }
    }
    __syncwarp();

    // o[r][c] = sum_j p[r][j] * v[j][lane + 32 c]
    float o[ROWS][CPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[r][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      float vv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pv = p[r * N + j];
#pragma unroll
        for (int c = 0; c < CPL; ++c) o[r][c] = fmaf(pv, vv[c], o[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = lane + 32 * c;
        if (i < N && d < D)
          out[((size_t)b * N + i) * C + h * D + d] = from_float<T>(o[r][c]);
      }
    }
    __syncwarp();  // q and p are rewritten by the next rows
  }
}

template <typename T, int CPL, int ROWS = (CPL <= 4 ? 8 : 4)>
int launch(const void* qkv, void* out, int B, int N, int C, int H,
           cudaStream_t s) {
  const int D = C / H;
  const size_t smem = sizeof(float) * ((size_t)N * (D + 1) + (size_t)N * D +
                                       (size_t)kWarps * ROWS * (D + N));
  if (smem > 48 * 1024) {
    // without this the launch is refused above the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T, CPL, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_kernel<T, CPL, ROWS><<<B * H, kThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B*N, 3C) in `dtype` with columns [q | k | v], head h at h*D..(h+1)*D
// of each; out (B*N, C) in `dtype`. N <= 128, C % H == 0, D = C / H <= 160.
extern "C" int cft_attention(const void* qkv, void* out, int B, int N, int C,
                             int H, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxTokens || H <= 0 || C % H ||
      C / H > 32 * kMaxCpl)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kBFloat16 && dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const bool b16 = dtype == kBFloat16;
  switch ((C / H + 31) / 32) {
    case 1: return b16 ? launch<bf16, 1>(qkv, out, B, N, C, H, s)
                       : launch<float, 1>(qkv, out, B, N, C, H, s);
    case 2: return b16 ? launch<bf16, 2>(qkv, out, B, N, C, H, s)
                       : launch<float, 2>(qkv, out, B, N, C, H, s);
    case 3: return b16 ? launch<bf16, 3>(qkv, out, B, N, C, H, s)
                       : launch<float, 3>(qkv, out, B, N, C, H, s);
    case 4: return b16 ? launch<bf16, 4>(qkv, out, B, N, C, H, s)
                       : launch<float, 4>(qkv, out, B, N, C, H, s);
    default: return b16 ? launch<bf16, 5>(qkv, out, B, N, C, H, s)
                        : launch<float, 5>(qkv, out, B, N, C, H, s);
  }
}
