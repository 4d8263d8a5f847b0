// LayerNorm over the fp32 residual stream of the CFT transformer stack.
//
// Replaces the `_ln` step of the TPU kernel `_kernel` in
// multispectral_object_detection_tpu/ops/pallas_fusion.py (fused_cft_stack),
// where the stream sat in VMEM. Here the stream (M, C) fp32 lives in device
// memory and each layer normalises it twice (before attention, before the MLP).
//
// Bound: bytes. It reads M*C*4 bytes and writes M*C*sizeof(T); the arithmetic
// is a few operations per element. Design: one warp per row, the row held in
// registers as float4, VEC of them per lane (a template parameter: the
// launcher picks the least of 2, 4, 8, 10 and 16 with 32 * 4 * VEC >= C, so
// C <= 2048), and the row is read from device memory once. Two-pass fp32 statistics as in `_ln`:
// mean first, then the mean of squared deviations; eps is added to the
// variance before rsqrt. The output is rounded once to the compute dtype.
#include "cft_common.cuh"

using namespace cft;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxVec = 16;  // float4 per lane: C <= 32 * 4 * 16 = 2048

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    layernorm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ out, int M,
                     int C, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const int nv = C / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * C);

  float4 v[VEC];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nv) {
      v[i] = xr[idx];
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mu = warp_sum(s) / (float)C;

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nv) {
      const float dx = v[i].x - mu, dy = v[i].y - mu;
      const float dz = v[i].z - mu, dw = v[i].w - mu;
      ss += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);

  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  T* o = out + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int idx = lane + 32 * i;
    if (idx < nv) {
      const float4 g = w4[idx], bb = b4[idx];
      const int c = idx * 4;
      o[c + 0] = from_float<T>((v[i].x - mu) * rstd * g.x + bb.x);
      o[c + 1] = from_float<T>((v[i].y - mu) * rstd * g.y + bb.y);
      o[c + 2] = from_float<T>((v[i].z - mu) * rstd * g.z + bb.z);
      o[c + 3] = from_float<T>((v[i].w - mu) * rstd * g.w + bb.w);
    }
  }
}

template <typename T, int VEC>
void launch(const float* x, const float* w, const float* b, void* out, int M,
            int C, float eps, cudaStream_t s) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  layernorm_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      x, w, b, static_cast<T*>(out), M, C, eps);
}

template <typename T>
void launch_vec(const float* x, const float* w, const float* b, void* out,
                int M, int C, float eps, cudaStream_t s) {
  const int vec = (C / 4 + 31) / 32;  // float4 per lane the row needs
  if (vec <= 2) launch<T, 2>(x, w, b, out, M, C, eps, s);
  else if (vec <= 4) launch<T, 4>(x, w, b, out, M, C, eps, s);
  else if (vec <= 8) launch<T, 8>(x, w, b, out, M, C, eps, s);
  else if (vec <= 10) launch<T, 10>(x, w, b, out, M, C, eps, s);
  else launch<T, kMaxVec>(x, w, b, out, M, C, eps, s);
}

}  // namespace

// x (M, C) fp32, w/b (C,) fp32, out (M, C) in `dtype`. C % 4 == 0, C <= 2048,
// all pointers 16-byte aligned (checked by the Python wrapper).
extern "C" int cft_layernorm(const void* x, const void* w, const void* b,
                             void* out, int M, int C, float eps, int dtype,
                             void* stream) {
  if (M <= 0 || C <= 0 || C % 4 != 0 || C > 32 * 4 * kMaxVec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == kBFloat16) {
    launch_vec<bf16>(xf, wf, bf, out, M, C, eps, s);
  } else if (dtype == kFloat32) {
    launch_vec<float>(xf, wf, bf, out, M, C, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
