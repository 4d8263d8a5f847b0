// Greedy NMS over a batch: every suppression step of every image in one
// launch, one block per image (K3).
//
// Replaces no TPU kernel: the JAX package's NMS
// (multispectral_object_detection_tpu/ops/nms.py) is an XLA loop, not a
// Pallas kernel. It replaces the Python loop of ops/nms._suppress on CUDA
// tensors, which the host enqueued as about 28 small launches a step (max,
// the IoU's max/min/sub/clamp/prod/div, where, index writes) with a blocking
// early-exit check every 8 steps. That loop stays as this kernel's plain twin
// (CPU tensors, and the exported graph's fixed trip).
//
// What it computes, per image b: K candidates in the order of ops/nms._select
// (a stable descending sort by score), their class-offset boxes (K, 4) xyxy
// fp32 and scores (K,) fp32, -1e9 where there is no candidate. A candidate is
// alive where its score > -5e8. Alive scores never increase along K, so the
// first alive index is the greedy argmax with ties to the lower index. Each
// step keeps that index, then kills it and every alive candidate whose IoU
// with it exceeds the threshold; it stops after max_det picks or when nothing
// is left alive. So candidate j is kept exactly when it is alive, fewer than
// max_det were kept before it, and its IoU with each of those is at most the
// threshold: a pick only ever kills candidates after it. The IoU rounds as
// ops/boxes.pairwise_iou does, operation for operation (round-to-nearest
// intrinsics, so nvcc contracts nothing into an FMA; max, min and the clamp
// pass NaN on as torch's do): one comparison flipped near the threshold would
// change the kept set.
//
// Bound: the chain of dependent picks, not bytes or FLOPs. The inputs are
// B*K*20 bytes (about 4 us at 3.35 TB/s for an eval batch of 32 x 20,160),
// but each of up to max_det picks depends on the ones before it. A first
// design kept the whole alive set as a bitmask and, for every pick, reread
// the boxes of all alive candidates after it from L2: 11.1 us a pick at the
// eval shapes (322 KB per image per pick). This one reads each box once.
// The block walks the candidates in tiles of its 1,024 threads, one
// candidate a thread, box and area kept in shared memory. (1) Each alive
// candidate of the tile is tested against the boxes kept by earlier tiles:
// the first 8,192 from a cache in shared memory (every thread reads the
// same one, a broadcast), any later ones from the boxes in device memory
// at their kept indices (a max_det past 8,192; never at the eval shapes).
// (2) The survivors form a 1,024-bit mask; warp 0 finds its first set bit
// (__ballot_sync, __ffs), that candidate is kept, and each survivor after
// it tests itself against it alone and clears its bit with one
// __ballot_sync a warp: two __syncthreads a pick and no device memory on
// the chain. The walk ends after max_det picks or the last tile.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;   // candidates a tile
constexpr int kWords = kThreads / 32;
constexpr int kCached = 8192;    // kept boxes in shared memory: 160 KB
constexpr float kAlive = -5e8f;  // ops/nms: _NEG / 2

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// Tensor.clamp(min=0), NaN kept
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// ops/boxes.pairwise_iou of the pick p (area area_p) with q (area area_q)
__device__ __forceinline__ float iou(float4 p, float area_p, float4 q,
                                     float area_q) {
  const float iw = clamp0(__fsub_rn(min_nan(p.z, q.z), max_nan(p.x, q.x)));
  const float ih = clamp0(__fsub_rn(min_nan(p.w, q.w), max_nan(p.y, q.y)));
  const float inter = __fmul_rn(iw, ih);
  return __fdiv_rn(
      inter, __fadd_rn(__fsub_rn(__fadd_rn(area_p, area_q), inter), 1e-7f));
}

__global__ void __launch_bounds__(kThreads)
    nms_suppress_kernel(const float4* __restrict__ boxes,
                        const float* __restrict__ scores, int K, int max_det,
                        float thr, long long* __restrict__ idxs,
                        unsigned char* __restrict__ vals,
                        long long* __restrict__ stats) {
  extern __shared__ float4 kept[];  // the first kCached kept boxes, then
                                    // their areas
  float* kept_area =
      reinterpret_cast<float*>(kept + (max_det < kCached ? max_det : kCached));
  __shared__ float4 tile_box[kThreads];
  __shared__ float tile_area[kThreads];
  __shared__ unsigned surv[kWords];  // bit t: tile candidate t still alive
  __shared__ int s_pick, s_count;
  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const float4* bx = boxes + (size_t)b * K;
  const float* sc = scores + (size_t)b * K;
  long long* out_i = idxs + (size_t)b * max_det;
  unsigned char* out_v = vals + (size_t)b * max_det;
  if (max_det == 0) {  // the plain loop runs no step and counts nothing
    if (t == 0) stats[2 * b] = stats[2 * b + 1] = 0;
    return;
  }

  if (t == 0) s_count = 0;
  __syncthreads();
  int count = 0;
  for (int k0 = 0; k0 < K; k0 += blockDim.x) {
    const int k = k0 + t;
    count += __popc(__ballot_sync(0xffffffffu, k < K && sc[k] > kAlive));
  }
  if (lane == 0 && count) atomicAdd(&s_count, count);

  int n = 0;  // picks so far, the same in every thread
  for (int k0 = 0; k0 < K && n < max_det; k0 += blockDim.x) {
    const int k = k0 + t;
    bool alive = k < K && sc[k] > kAlive;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    float area_q = 0.f;
    if (alive) {
      q = bx[k];
      area_q = area(q);
      const int cached = n < kCached ? n : kCached;
      for (int i = 0; alive && i < cached; ++i)  // (1) earlier tiles' picks
        alive = !(iou(kept[i], kept_area[i], q, area_q) > thr);
      for (int i = kCached; alive && i < n; ++i) {  // past the cache: written
        const float4 p = bx[out_i[i]];  // by thread 0 before the tile barrier
        alive = !(iou(p, area(p), q, area_q) > thr);
      }
    }
    tile_box[t] = q;
    tile_area[t] = area_q;
    const unsigned alive_bits = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) surv[warp] = alive_bits;
    __syncthreads();
    while (true) {  // (2) greedy within the tile
      if (warp == 0) {
        const unsigned w = lane < blockDim.x / 32 ? surv[lane] : 0u;
        const unsigned nz = __ballot_sync(0xffffffffu, w != 0u);
        const int l = nz ? __ffs(nz) - 1 : 0;  // the first word with a bit
        const unsigned wl = __shfl_sync(0xffffffffu, w, l);
        if (lane == 0) s_pick = nz ? l * 32 + __ffs(wl) - 1 : -1;
      }
      __syncthreads();
      const int pick = s_pick;
      if (pick < 0) break;  // the same in every thread
      if (t == 0) {
        out_i[n] = k0 + pick;
        out_v[n] = 1;
        if (n < kCached) {
          kept[n] = tile_box[pick];
          kept_area[n] = tile_area[pick];
        }
      }
      if (++n == max_det) break;
      if (warp >= pick / 32) {  // warps with a bit at or after the pick
        const bool kill =
            t == pick ||
            (t > pick && ((surv[warp] >> lane) & 1u) &&
             iou(tile_box[pick], tile_area[pick], q, area_q) > thr);
        const unsigned killed = __ballot_sync(0xffffffffu, kill);
        if (lane == 0 && killed) surv[warp] &= ~killed;
      }
      __syncthreads();
    }
    __syncthreads();  // kept[] and tile_box[] read before the next tile
  }
  // the slots after the last pick: index 0, not valid, as the plain loop's
  for (int i = n + t; i < max_det; i += blockDim.x) {
    out_i[i] = 0;
    out_v[i] = 0;
  }
  if (t == 0) {
    stats[2 * b] = s_count;
    stats[2 * b + 1] = n;
  }
}

}  // namespace

// boxes (B, K, 4) and scores (B, K) fp32, as ops/nms._select gives them;
// idxs (B, max_det) int64, vals (B, max_det) bool and stats (B, 2) int64
// [candidates, picks] are written whole. B > 0, K < 2^30, max_det >= 0, all
// pointers 16-byte aligned (checked by the Python wrapper).
extern "C" int nms_suppress(const void* boxes, const void* scores, int B,
                            int K, int max_det, float iou_thres, void* idxs,
                            void* vals, void* stats, void* stream) {
  if (B <= 0 || K < 0 || K >= (1 << 30) || max_det < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = K >= kThreads ? kThreads : K > 32 ? (K + 31) / 32 * 32
                                                        : 32;
  const size_t smem = (size_t)(max_det < kCached ? max_det : kCached) *
                      (sizeof(float4) + sizeof(float));
  if (smem > 16 * 1024) {  // with the static tile, past the 48 KB default
    const cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_suppress_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), K,
      max_det, iou_thres, static_cast<long long*>(idxs),
      static_cast<unsigned char*>(vals), static_cast<long long*>(stats));
  return (int)cudaGetLastError();
}
