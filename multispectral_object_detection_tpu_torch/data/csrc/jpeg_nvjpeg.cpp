// JPEG decode through nvJPEG (the CUDA toolkit's decoder) for the port's
// image reader, where libjpeg's headers are missing but CUDA's are: the
// same entry points as jpeg_decode.cpp. One decoder handle, one stream
// and one device buffer per process, behind a mutex; the decoded RGB image
// is copied back to the caller's host buffer.
//
// Plain C interface for ctypes; built with g++ -lnvjpeg -lcudart by
// data/native.py.

#include <cstdint>
#include <mutex>

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

int info(const uint8_t* data, long n, int* h, int* w) {
  int components;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t st = nvjpegGetImageInfo(g_handle, data, (size_t)n,
                                         &components, &sub, ws, hs);
  if (st != NVJPEG_STATUS_SUCCESS) return -100 - (int)st;
  *h = hs[0];
  *w = ws[0];
  return 0;
}

}  // namespace

extern "C" {

// (height, width) of a JPEG in memory; 0 on success.
int msod_jpeg_size(const uint8_t* data, long n, int* h, int* w) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int err = init();
  return err ? err : info(data, n, h, w);
}

// Decode to HWC RGB into out (out_h * out_w * 3 bytes); 0 on success, -2
// when the size is not (out_h, out_w), another negative code on an error.
int msod_jpeg_decode(const uint8_t* data, long n, uint8_t* out, int out_h,
                     int out_w) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int err = init();
  int h, w;
  if (err || (err = info(data, n, &h, &w))) return err;
  if (h != out_h || w != out_w) return -2;
  const size_t bytes = (size_t)h * w * 3;
  if (bytes > g_cap) {
    if (g_buf) cudaFree(g_buf);
    g_buf = nullptr;
    g_cap = 0;
    cudaError_t ce = cudaMalloc(&g_buf, bytes);
    if (ce != cudaSuccess) return -1000 - (int)ce;
    g_cap = bytes;
  }
  nvjpegImage_t img = {};
  img.channel[0] = g_buf;
  img.pitch[0] = (size_t)w * 3;
  nvjpegStatus_t st = nvjpegDecode(g_handle, g_state, data, (size_t)n,
                                   NVJPEG_OUTPUT_RGBI, &img, g_stream);
  if (st != NVJPEG_STATUS_SUCCESS) return -100 - (int)st;
  cudaError_t ce = cudaMemcpyAsync(out, g_buf, bytes, cudaMemcpyDeviceToHost,
                                   g_stream);
  if (ce == cudaSuccess) ce = cudaStreamSynchronize(g_stream);
  return ce == cudaSuccess ? 0 : -1000 - (int)ce;
}

}  // extern "C"
