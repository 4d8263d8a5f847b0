// JPEG decode through nvJPEG (the CUDA toolkit's decoder) for the port's
// image reader, where libjpeg's headers are missing but CUDA's are: the
// same entry points as jpeg_decode.cpp. One decoder handle, one stream
// and one device buffer per process, behind a mutex; the decoded RGB image
// is copied back to the caller's host buffer. A 4-component (CMYK) file is
// decoded to its planes as stored and turned into RGB on the host by
// OpenCV's rule for Adobe-inverted data, as jpeg_decode.cpp does.
//
// Plain C interface for ctypes; built with g++ -lnvjpeg -lcudart by
// data/native.py.

#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
cudaStream_t g_stream = nullptr;
uint8_t* g_buf = nullptr;
size_t g_cap = 0;

// 0, or a negative code: -100 - nvjpegStatus_t, -1000 - cudaError_t
int init() {
  if (g_handle) return 0;
  cudaError_t ce = cudaStreamCreateWithFlags(&g_stream, cudaStreamNonBlocking);
  if (ce != cudaSuccess) return -1000 - (int)ce;
  nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
  if (st != NVJPEG_STATUS_SUCCESS) return -100 - (int)st;
  st = nvjpegJpegStateCreate(g_handle, &g_state);
  if (st != NVJPEG_STATUS_SUCCESS) return -100 - (int)st;
  return 0;
}

struct Info {
  int components;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
};

int info(const uint8_t* data, long n, Info* inf) {
  nvjpegChromaSubsampling_t sub;
  nvjpegStatus_t st = nvjpegGetImageInfo(g_handle, data, (size_t)n,
                                         &inf->components, &sub, inf->ws,
                                         inf->hs);
  return st == NVJPEG_STATUS_SUCCESS ? 0 : -100 - (int)st;
}

int reserve(size_t bytes) {
  if (bytes <= g_cap) return 0;
  if (g_buf) cudaFree(g_buf);
  g_buf = nullptr;
  g_cap = 0;
  cudaError_t ce = cudaMalloc(&g_buf, bytes);
  if (ce != cudaSuccess) return -1000 - (int)ce;
  g_cap = bytes;
  return 0;
}

int copy_back(void* dst, size_t bytes) {
  cudaError_t ce = cudaMemcpyAsync(dst, g_buf, bytes, cudaMemcpyDeviceToHost,
                                   g_stream);
  if (ce == cudaSuccess) ce = cudaStreamSynchronize(g_stream);
  return ce == cudaSuccess ? 0 : -1000 - (int)ce;
}

// CMYK: the four planes as stored (every one at full size, else -3), then
// each of C, M, Y becomes k - (255 - v)k/256 (OpenCV's icvCvt_CMYK2BGR).
int decode_cmyk(const uint8_t* data, long n, const Info& inf, uint8_t* out) {
  const int h = inf.hs[0], w = inf.ws[0];
  for (int c = 0; c < 4; ++c)
    if (inf.ws[c] != w || inf.hs[c] != h) return -3;
  const size_t plane = (size_t)h * w;
  int err = reserve(plane * 4);
  if (err) return err;
  nvjpegImage_t img = {};
  for (int c = 0; c < 4; ++c) {
    img.channel[c] = g_buf + c * plane;
    img.pitch[c] = (size_t)w;
  }
  nvjpegStatus_t st = nvjpegDecode(g_handle, g_state, data, (size_t)n,
                                   NVJPEG_OUTPUT_UNCHANGED, &img, g_stream);
  if (st != NVJPEG_STATUS_SUCCESS) return -100 - (int)st;
  std::vector<uint8_t> planes(plane * 4);
  if ((err = copy_back(planes.data(), plane * 4))) return err;
  for (size_t i = 0; i < plane; ++i) {
    const int k = planes[3 * plane + i];
    for (int c = 0; c < 3; ++c)
      out[3 * i + c] = (uint8_t)(k - (((255 - planes[c * plane + i]) * k) >> 8));
  }
  return 0;
}

}  // namespace

extern "C" {

// (height, width) of a JPEG in memory; 0 on success.
int msod_jpeg_size(const uint8_t* data, long n, int* h, int* w) {
  std::lock_guard<std::mutex> lock(g_mutex);
  Info inf;
  int err = init();
  if (err || (err = info(data, n, &inf))) return err;
  *h = inf.hs[0];
  *w = inf.ws[0];
  return 0;
}

// Decode to HWC RGB into out (out_h * out_w * 3 bytes); 0 on success, -2
// when the size is not (out_h, out_w), -3 for a CMYK file with subsampled
// planes, another negative code on an error.
int msod_jpeg_decode(const uint8_t* data, long n, uint8_t* out, int out_h,
                     int out_w) {
  std::lock_guard<std::mutex> lock(g_mutex);
  Info inf;
  int err = init();
  if (err || (err = info(data, n, &inf))) return err;
  const int h = inf.hs[0], w = inf.ws[0];
  if (h != out_h || w != out_w) return -2;
  if (inf.components == 4) return decode_cmyk(data, n, inf, out);
  const size_t bytes = (size_t)h * w * 3;
  if ((err = reserve(bytes))) return err;
  nvjpegImage_t img = {};
  img.channel[0] = g_buf;
  img.pitch[0] = (size_t)w * 3;
  nvjpegStatus_t st = nvjpegDecode(g_handle, g_state, data, (size_t)n,
                                   NVJPEG_OUTPUT_RGBI, &img, g_stream);
  if (st != NVJPEG_STATUS_SUCCESS) return -100 - (int)st;
  return copy_back(out, bytes);
}

}  // extern "C"
