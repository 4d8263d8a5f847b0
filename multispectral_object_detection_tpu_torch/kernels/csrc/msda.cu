// Multi-scale deformable attention's sampling (Deformable DETR's MSDA core)
// in one launch per call (K4).
//
// Replaces no TPU kernel: the JAX package has no DETR. It replaces, on CUDA
// tensors, the body of ops/msda.ms_deform_attn, which stays as this kernel's
// plain twin (CPU tensors): per level an fp32 channels-last copy of the
// level's value, a grid_sample that wrote an (N*M, 32, Q, P) fp32 tensor of
// samples, a multiply by the weights, a sum over the points in a kernel of
// its own and an add into an fp32 accumulator; then a transpose and a cast.
//
// What it computes, for each image n, query q and head m (value (N, S, M, D)
// with D = 32, offsets (N, Q, M*L*P*2) and logits (N, Q, M*L*P) in the
// value's dtype, reference (N or 1, Q, 2) fp32):
//
//   a   = softmax over the L*P logits of (n, q, m)                  (fp32)
//   loc = reference[n, q] + offset[n, q, m, l, p] / (W_l, H_l)       (fp32)
//   out[n, q, m*D:(m+1)*D] = sum_{l,p} a * bilinear(value_l[n, :, m], loc)
//
// with grid_sample's bilinear (align_corners False, zeros outside): the
// pixel coordinate is loc * W - 0.5, and a corner outside the level adds 0.
// Values are read in their dtype and widened in registers (exact for bf16,
// as the plain path's fp32 copy is); locations, softmax and the sums are
// fp32; the output is stored once, in the value's dtype, in the (N, Q, M*D)
// layout the output projection reads. The level shapes and starts travel by
// value as kernel arguments: a call copies nothing to the device and reads
// nothing back.
//
// Bound: gathered bytes through L1 and L2, not device memory or FLOPs. An
// encoder call of the DETR cell (8 images of 21,760 tokens, 8 heads, 4
// levels, 4 points) does 10 FLOPs a channel-sample, 7.1 GFLOP (7 us at the
// bf16 peak), and must move about 312 MB through device memory (the value,
// the offsets and logits, the output: about 0.1 ms at 3.35 TB/s); but every
// sample reads 4 corners of one head's 32 channels, 64 bytes each, 5.7 GB of
// L1/L2 requests a call. The design makes those requests cheap:
// - a quad of 4 lanes per (image, query, head); each lane owns 8 channels
//   and loads a corner as one 16-byte vector, so the quad's 4 loads are the
//   head's whole 64-byte line, and a warp serves one query's 8 heads;
// - softmax and locations in the quad: lane k reads level k's P offsets and
//   logits, the quad takes the softmax's max and sum by __shfl_xor_sync, and
//   each level's locations and weights reach the quad by __shfl_sync: no
//   shared or device memory between the steps;
// - a block is 8 consecutive queries, the grid image-major: encoder queries
//   are neighbouring pixel centres of one level, so their corners (a few
//   pixels of learned offset away) fall on the same lines and L1 serves the
//   repeats, and one image's value (11 MB at the cell's shapes) stays in the
//   50 MB L2 while its queries run;
// - all corner loads of up to 4 points are issued before any is used (the
//   points unrolled), for memory-level parallelism;
// - each lane stores its 8 channels as one 16-byte vector: a query's 8
//   heads are 512 contiguous bytes.
// D = 32 (every published Deformable DETR, DINO and RT-DETR), L <= 4 (one
// level a lane of the quad) and P <= 8; anything else is refused.
#include "cft_common.cuh"

using namespace cft;

namespace {

constexpr int kThreads = 256;  // 64 quads: 8 queries of 8 heads
constexpr int kHeadDim = 32;   // channels a head: 4 lanes x 8
constexpr int kMaxLevels = 4;  // one level a lane of the quad
constexpr unsigned kAll = 0xffffffffu;

struct Levels {  // passed by value: no device copy of the shapes
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// 8 consecutive channels of one pixel, as loaded
template <typename T>
struct Pix;

template <>
struct Pix<bf16> {
  static constexpr int kChunk = 4;  // points whose corners load together
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p, bool ok) {
    r = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  // s[i] += w * channel i (bf16 widened exactly: its bits are fp32's top half)
  __device__ __forceinline__ void fma_into(float (&s)[8], float w) const {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[2 * i] = fmaf(__uint_as_float(u[i] << 16), w, s[2 * i]);
      s[2 * i + 1] = fmaf(__uint_as_float(u[i] & 0xffff0000u), w, s[2 * i + 1]);
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float (&a)[8]) {
    uint4 v;
    unsigned* u = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct Pix<float> {
  static constexpr int kChunk = 2;  // twice the registers a corner
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p, bool ok) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    lo = ok ? __ldg(reinterpret_cast<const float4*>(p)) : z;
    hi = ok ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
  }
  __device__ __forceinline__ void fma_into(float (&s)[8], float w) const {
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = fmaf(v[i], w, s[i]);
  }
  __device__ __forceinline__ static void store(float* p, const float (&a)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
};

// a[i] for a lane-dependent i, by selects: no local-memory copy of the
// argument
__device__ __forceinline__ int pick(const int (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// 3 blocks an SM (at most 85 registers a thread): 24 warps of loads in
// flight; 2 (the 79 registers nvcc picks alone) or 4 (64) read 8-14 % slower
// on an H100 at the DETR cell's encoder shapes
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 3)
    msda_kernel(const T* __restrict__ value, const T* __restrict__ offsets,
                const T* __restrict__ logits,
                const float* __restrict__ reference, T* __restrict__ out,
                int S, int Q, int M, int L, int ref_batched, int pairs,
                Levels lv) {
  const int g = blockIdx.x * (kThreads / 4) + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;  // lane in the quad
  const bool active = g < pairs;    // a whole quad is in or out
  const int gq = active ? g / M : 0;  // (n, q) flat
  const int m = active ? g - gq * M : 0;
  const int n = gq / Q, q = gq - n * Q;

  // 1. lane `sub` holds level `sub`'s P locations (pixel coordinates) and
  //    logits; the quad's softmax over all L*P logits
  float px[P], py[P], pa[P];
#pragma unroll
  for (int p = 0; p < P; ++p) px[p] = py[p] = pa[p] = 0.f;
  float mx = -INFINITY;
  const bool has_level = active && sub < L;
  if (has_level) {
    const size_t head = (size_t)gq * M + m;
    const T* o = offsets + head * (L * P * 2) + sub * (P * 2);
    const T* lg = logits + head * (L * P) + sub * P;
    const float* r = reference + (ref_batched ? (size_t)gq : (size_t)q) * 2;
    const float rx = r[0], ry = r[1];
    const float W = (float)pick(lv.w, sub), H = (float)pick(lv.h, sub);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      px[p] = (rx + to_float(o[2 * p]) / W) * W - 0.5f;
      py[p] = (ry + to_float(o[2 * p + 1]) / H) * H - 0.5f;
      pa[p] = to_float(lg[p]);
      mx = fmaxf(mx, pa[p]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 1, 4));
  mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 2, 4));
  float sum = 0.f;
  if (has_level) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pa[p] = expf(pa[p] - mx);
      sum += pa[p];
    }
  }
  sum += __shfl_xor_sync(kAll, sum, 1, 4);
  sum += __shfl_xor_sync(kAll, sum, 2, 4);
  if (has_level) {
#pragma unroll
    for (int p = 0; p < P; ++p) pa[p] = pa[p] / sum;
  }

  // 2. every level's points, broadcast from the quad's lane of that level;
  //    each lane samples its 8 channels
  constexpr int kChunk = Pix<T>::kChunk;
  const size_t row = (size_t)M * kHeadDim;  // elements from pixel to pixel
  const T* vbase = value + (size_t)n * S * row + m * kHeadDim + sub * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int H = lv.h[l], W = lv.w[l];
    const T* vl = vbase + (size_t)lv.start[l] * row;
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += kChunk) {
      Pix<T> v[kChunk][4];
      float cw[kChunk][4], a[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int p = p0 + j;
        if (p >= P) break;
        const float ix = __shfl_sync(kAll, px[p], l, 4);
        const float iy = __shfl_sync(kAll, py[p], l, 4);
        a[j] = __shfl_sync(kAll, pa[p], l, 4);
        // some corner inside the level (false for NaN): else all add 0
        const bool in = active && ix > -1.f && ix < (float)W && iy > -1.f &&
                        iy < (float)H;
        const float fx = in ? floorf(ix) : 0.f, fy = in ? floorf(iy) : 0.f;
        const int x0 = (int)fx, y0 = (int)fy;
        // grid_sample's weights: nw, ne, sw, se
        const float ex = in ? ix - fx : 0.f, ey = in ? iy - fy : 0.f;
        const float wx = in ? (fx + 1.f) - ix : 0.f;
        const float wy = in ? (fy + 1.f) - iy : 0.f;
        cw[j][0] = wx * wy;
        cw[j][1] = ex * wy;
        cw[j][2] = wx * ey;
        cw[j][3] = ex * ey;
        const bool okx0 = x0 >= 0, okx1 = x0 + 1 < W;
        const bool oky0 = y0 >= 0, oky1 = y0 + 1 < H;
        const long long at = (long long)y0 * W + x0;  // may be -1 - W
        const T* c = vl + at * (long long)row;
        v[j][0].load(c, in && oky0 && okx0);
        v[j][1].load(c + row, in && oky0 && okx1);
        v[j][2].load(c + W * row, in && oky1 && okx0);
        v[j][3].load(c + (W + 1) * row, in && oky1 && okx1);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (p0 + j >= P) break;
        float s[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) v[j][c].fma_into(s, cw[j][c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(a[j], s[i], acc[i]);
      }
    }
  }
  if (active) Pix<T>::store(out + (size_t)g * kHeadDim + sub * 8, acc);
}

template <typename T, int P>
cudaError_t launch(const void* value, const void* offsets, const void* logits,
                   const void* reference, void* out, int S, int Q, int M,
                   int L, int ref_batched, int pairs, const Levels& lv,
                   cudaStream_t stream) {
  const int blocks = (pairs + kThreads / 4 - 1) / (kThreads / 4);
  msda_kernel<T, P><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const T*>(offsets),
      static_cast<const T*>(logits), static_cast<const float*>(reference),
      static_cast<T*>(out), S, Q, M, L, ref_batched, pairs, lv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_points(int P, const void* value, const void* offsets,
                          const void* logits, const void* reference, void* out,
                          int S, int Q, int M, int L, int ref_batched,
                          int pairs, const Levels& lv, cudaStream_t stream) {
#define MSDA_POINTS(NP)                                                      \
  case NP:                                                                   \
    return launch<T, NP>(value, offsets, logits, reference, out, S, Q, M, L, \
                         ref_batched, pairs, lv, stream);
  switch (P) {
    MSDA_POINTS(1)
    MSDA_POINTS(2)
    MSDA_POINTS(3)
    MSDA_POINTS(4)
    MSDA_POINTS(5)
    MSDA_POINTS(6)
    MSDA_POINTS(7)
    MSDA_POINTS(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MSDA_POINTS
}

}  // namespace

// value (N, S, M, 32), offsets (N, Q, M*L*P*2), logits (N, Q, M*L*P) and out
// (N, Q, M*32) in one dtype (bf16 or fp32), reference (N or 1, Q, 2) fp32
// (ref_batched 1: batch N; 0: one row for every image); level l is (h_l,
// w_l), its tokens start after the levels before it; the unused levels'
// shapes are 0. The Python wrapper (ops/msda.check_msda) checks the rest:
// 1 <= L <= 4, the shapes tile S, N * Q * M <= 2^30, value and out 16-byte
// aligned. Returns cudaErrorInvalidValue for a P or a dtype it has no
// instance of.
extern "C" int msda_sample(const void* value, const void* offsets,
                           const void* logits, const void* reference,
                           void* out, int N, int S, int Q, int M, int L,
                           int P, int ref_batched, int h0, int w0, int h1,
                           int w1, int h2, int w2, int h3, int w3, int dtype,
                           void* stream) {
  Levels lv;
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int l = 0, start = 0; l < kMaxLevels; ++l) {
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.start[l] = start;
    start += hs[l] * ws[l];
  }
  const int pairs = N * Q * M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)launch_points<bf16>(P, value, offsets, logits, reference, out,
                                    S, Q, M, L, ref_batched, pairs, lv, s);
  if (dtype == kFloat32)
    return (int)launch_points<float>(P, value, offsets, logits, reference,
                                     out, S, Q, M, L, ref_batched, pairs, lv,
                                     s);
  return (int)cudaErrorInvalidValue;
}
