// Per-(image, head) softmax attention of the CFT transformer stack:
//     o = softmax(Q K^T / sqrt(D)) V     over the N <= 128 tokens of one image
//
// Replaces the static (image, head) loop of the TPU kernel `_kernel` in
// multispectral_object_detection_tpu/ops/pallas_fusion.py (fused_cft_stack).
//
// Bound: bytes. Each (image, head) reads 3*N*D values and writes N*D, and
// does 4*N*N*D operations: at N = 128 that is about 100 operations per
// byte in bf16, under the card's ridge.
//
// bf16 design: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32
// accumulator). All N keys of a head fit at once, so there is one exact pass
// with no online rescaling. Grid (B*H, ceil(N/64)); a block of 4 warps takes
// 64 query rows, 16 a warp, so the bs16 main path has 256 blocks. The block
// stages its Q rows and the head's K and V once with 16-byte cp.async, in
// two groups (Q and K, then V, which lands during Q K^T; four groups, one
// per half of K and of V, measured slower), in bf16, rows an odd number of
// 16-byte chunks apart so that ldmatrix is free of bank conflicts (107,520
// bytes at D = 160: two blocks an SM). Keys past N and, where D % 16 == 8,
// the depth up to the next multiple of 16 are filled with zeros, so QK^T
// runs over whole k16 steps. Each warp keeps its
// 16 x 128 scores in registers (64 floats a lane); row max and sum come from
// quad shuffles; keys past N are masked to -inf. The probabilities, rounded
// to bf16, become the A fragments of P.V in registers (P never goes through
// shared memory), and V's B fragments come from ldmatrix.trans, n8 tiles of
// the head width, so any D % 8 == 0 up to 160 works. Rows past N are not
// stored.
// fp32 design (used only by the checks): CUDA-core FMA with no TF32. K and V
// widened into shared memory, a warp scores ROWS query rows at a time with
// its scores in registers, the probabilities go through shared memory.
//
// Rounding follows `_kernel`: fp32 logits scaled by 1/sqrt(D), fp32 softmax,
// the probabilities rounded to the compute dtype, P.V accumulated in fp32,
// the result rounded once. The bf16 path multiplies by the reciprocals of
// sqrt(D) and of the row sum where `_kernel` divides (the fp32 divisions
// were measured to cost a large share of its time); that moves a logit or
// a probability by an fp32 ulp or two before its bf16 rounding. The fp32
// path divides.
#include "cft_common.cuh"

using namespace cft;

namespace {

constexpr int kMaxTokens = 128;
constexpr int kMaxHeadWidth = 160;

// ---------------------------------------------------------------- bf16 path
constexpr int kQRows = 64;  // query rows per block, 16 per warp

// bf16 elements per staged row: D rounded up to 16, + 8, so that rows are
// an odd number of 16-byte chunks apart and ldmatrix's 8 rows hit 8 banks
__host__ __device__ __forceinline__ int staged_ld(int D) {
  return ((D + 15) / 16) * 16 + 8;
}

// DMAX: D rounded up to a multiple of 32 (bounds the unrolled loops and the
// output registers); loops stop at the runtime D
template <int DMAX>
__global__ void __launch_bounds__(128)
    attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         int N, int C, int H) {
  const int D = C / H, Dp = (D + 15) / 16 * 16, LD = staged_ld(D);
  const int b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kQRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // kMaxTokens x LD
  bf16* Vs = Ks + kMaxTokens * LD;    // kMaxTokens x LD
  bf16* Qs = Vs + kMaxTokens * LD;    // kQRows x LD

  const size_t ld = 3 * (size_t)C;  // qkv row: [q (C) | k (C) | v (C)]
  const bf16* base = qkv + (size_t)b * N * ld + h * D;
  const int chunks = Dp / 8;  // 16-byte chunks of a staged row
  // rows r0 .. r0+rows-1 of one of q, k, v (col = 0, C, 2C) into dst; rows
  // past N and the depth past D as zeros
  auto stage = [&](bf16* dst, int col, int r0, int rows) {
    for (int e = threadIdx.x; e < rows * chunks; e += 128) {
      const int j = r0 + e / chunks, c = (e % chunks) * 8;
      const bool ok = j < N && c < D;
      cp_async16_zfill(dst + (e / chunks) * LD + c,
                       base + col + (ok ? j * ld + c : 0), ok);
    }
  };
  // two cp.async groups: Q and K, then V, which lands during Q K^T
  stage(Qs, 0, q0, kQRows);
  stage(Ks, C, 0, kMaxTokens);
  cp_async_commit();
  stage(Vs, 2 * C, 0, kMaxTokens);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const bool has_rows = q0 + warp * 16 < N;

  // S = Q K^T: 16 rows x 128 keys as 16 n8 tiles; s[t][2h + e] is row
  // lane/4 + 8h, key 8t + 2(lane%4) + e
  float s[kMaxTokens / 8][4];
#pragma unroll
  for (int t = 0; t < kMaxTokens / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  const bf16* q = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* k = Ks + ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < DMAX; kk += 16) {
    if (kk >= Dp || !has_rows) break;
    unsigned a[4];
    ldmatrix_x4(a, q + kk);
#pragma unroll
    for (int t = 0; t < kMaxTokens / 16; ++t) {  // keys 16t .. 16t+15
      unsigned bk[4];
      ldmatrix_x4(bk, k + t * 16 * LD + kk);
      mma_bf16(s[2 * t], a, bk[0], bk[1]);
      mma_bf16(s[2 * t + 1], a, bk[2], bk[3]);
    }
  }

  // softmax of rows lane/4 and lane/4 + 8 over the quad's 4 lanes
  const float inv_sqrt_d = 1.f / sqrtf((float)D);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < kMaxTokens / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * t + 2 * (lane % 4) + e % 2;
      s[t][e] = j < N ? s[t][e] * inv_sqrt_d : -INFINITY;
      mx[e / 2] = fmaxf(mx[e / 2], s[t][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int t = 0; t < kMaxTokens / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = expf(s[t][e] - mx[e / 2]);  // 0 for masked keys
      sum[e / 2] += s[t][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  // O = P V: the probabilities, rounded to bf16, are the A fragments of
  // keys 16t .. 16t+15 as they lie in s[2t] and s[2t+1]
  float o[DMAX / 8][4];
#pragma unroll
  for (int t = 0; t < DMAX / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  const bf16* v = Vs + (lane % 16) * LD + (lane / 16) * 8;
  cp_async_wait<0>();  // V
  __syncthreads();
  if (!has_rows) return;  // after the block's last barrier
#pragma unroll
  for (int t = 0; t < kMaxTokens / 16; ++t) {
    unsigned a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows lane/4 + 8 (i % 2), n8 tile i / 2
      const int r = i % 2;
      const __nv_bfloat162 pk =
          __floats2bfloat162_rn(s[2 * t + i / 2][2 * r] * inv[r],
                                s[2 * t + i / 2][2 * r + 1] * inv[r]);
      a[i] = *reinterpret_cast<const unsigned*>(&pk);
    }
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; dt += 2) {  // head-width tiles dt, dt+1
      if (8 * dt >= D) break;
      const bf16* vp = v + t * 16 * LD + 8 * dt;
      if (8 * dt + 8 < D) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vp);
        mma_bf16(o[dt], a, bv[0], bv[1]);
        mma_bf16(o[dt + 1], a, bv[2], bv[3]);
      } else {  // D % 16 == 8: the last tile alone
        unsigned bv[2];
        ldmatrix_x2_trans(bv, vp - (lane / 16) * 8);
        mma_bf16(o[dt], a, bv[0], bv[1]);
      }
    }
  }

  const int i0 = q0 + warp * 16 + lane / 4;
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    const int d = 8 * dt + 2 * (lane % 4);
    if (8 * dt >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i < N)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((size_t)b * N + i) * C + h * D + d) =
            __floats2bfloat162_rn(o[dt][2 * r], o[dt][2 * r + 1]);
    }
  }
}

template <int DMAX>
int launch_bf16(const void* qkv, void* out, int B, int N, int C, int H,
                cudaStream_t s) {
  const int smem = (2 * kMaxTokens + kQRows) * staged_ld(C / H) * 2;
  if (smem > 48 * 1024) {
    // without this the launch is refused above the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        attention_mma_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_mma_kernel<DMAX>
      <<<dim3(B * H, (N + kQRows - 1) / kQRows), 128, smem, s>>>(
          static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, C, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerLane = kMaxTokens / 32;

// CPL = ceil(D / 32): the D columns a lane owns in P.V; ROWS: the query rows
// a warp works on at once
template <int CPL, int ROWS>
__global__ void __launch_bounds__(kThreads)
    attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         int N, int C, int H) {
  const int D = C / H;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ float smem[];
  float* Ks = smem;                     // N x (D + 1)
  float* Vs = Ks + N * (D + 1);         // N x D
  float* Qs = Vs + N * D;               // kWarps x ROWS x D
  float* Ps = Qs + kWarps * ROWS * D;  // kWarps x ROWS x N

  const size_t ld = 3 * (size_t)C;  // qkv row: [q (C) | k (C) | v (C)]
  const float* base = qkv + (size_t)b * N * ld;
#pragma unroll 8
  for (int e = tid; e < N * D; e += kThreads) {  // unrolled: loads in flight
    const int j = e / D, d = e % D;
    Ks[j * (D + 1) + d] = base[j * ld + C + h * D + d];
    Vs[j * D + d] = base[j * ld + 2 * C + h * D + d];
  }
  __syncthreads();

  const float sqrt_d = sqrtf((float)D);
  float* q = Qs + warp * ROWS * D;
  float* p = Ps + warp * ROWS * N;
  for (int i0 = warp * ROWS; i0 < N; i0 += kWarps * ROWS) {
    for (int e = lane; e < ROWS * D; e += 32) {
      const int i = i0 + e / D;
      q[e] = i < N ? base[i * ld + h * D + e % D] : 0.f;
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

    // softmax per row
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
        if (j < N) p[r * N + j] = s[r][t] / sum;
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
        if (i < N && d < D) out[((size_t)b * N + i) * C + h * D + d] = o[r][c];
      }
    }
    __syncwarp();  // q and p are rewritten by the next rows
  }
}

// above D = 128, 8 rows per warp would need more shared memory than a block
// may have (238,080 bytes at D = 160), so a warp takes 4
template <int CPL, int ROWS = (CPL <= 4 ? 8 : 4)>
int launch_f32(const void* qkv, void* out, int B, int N, int C, int H,
               cudaStream_t s) {
  const int D = C / H;
  const size_t smem = sizeof(float) * ((size_t)N * (D + 1) + (size_t)N * D +
                                       (size_t)kWarps * ROWS * (D + N));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_f32_kernel<CPL, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_f32_kernel<CPL, ROWS><<<B * H, kThreads, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B*N, 3C) in `dtype` with columns [q | k | v], head h at h*D..(h+1)*D
// of each; out (B*N, C) in `dtype`. N <= 128, C % H == 0, D = C / H a
// multiple of 8 and at most 160.
extern "C" int cft_attention(const void* qkv, void* out, int B, int N, int C,
                             int H, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxTokens || H <= 0 || C % H || (C / H) % 8 ||
      C / H > kMaxHeadWidth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dw = (C / H + 31) / 32;  // the head width in 32s
  if (dtype == kBFloat16) {
    switch (dw) {
      case 1: return launch_bf16<32>(qkv, out, B, N, C, H, s);
      case 2: return launch_bf16<64>(qkv, out, B, N, C, H, s);
      case 3: return launch_bf16<96>(qkv, out, B, N, C, H, s);
      case 4: return launch_bf16<128>(qkv, out, B, N, C, H, s);
      default: return launch_bf16<160>(qkv, out, B, N, C, H, s);
    }
  }
  if (dtype == kFloat32) {
    switch (dw) {
      case 1: return launch_f32<1>(qkv, out, B, N, C, H, s);
      case 2: return launch_f32<2>(qkv, out, B, N, C, H, s);
      case 3: return launch_f32<3>(qkv, out, B, N, C, H, s);
      case 4: return launch_f32<4>(qkv, out, B, N, C, H, s);
      default: return launch_f32<5>(qkv, out, B, N, C, H, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
