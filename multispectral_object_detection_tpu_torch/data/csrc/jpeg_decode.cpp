// JPEG decode through libjpeg for the port's image reader: the JPEG part of
// the JAX package's native/image_ops.cpp, in a library of its own so that
// the geometry library (image_ops.cpp) builds where libjpeg's headers are
// missing. Errors return a non-zero code instead of libjpeg's exit().
// CMYK and YCCK files are read as CMYK and turned into RGB by OpenCV's
// rule for Adobe-inverted data (grfmt_jpeg.cpp, icvCvt_CMYK2BGR), so that
// they decode to cv2.imread's pixels.
//
// Plain C interface for ctypes; built with g++ -ljpeg by data/native.py.

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>

namespace {

struct ErrorManager {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrorManager*>(cinfo->err)->jump, 1);
}

void quiet(j_common_ptr, int) {}

// One row of inverted CMYK -> RGB: each of C, M, Y becomes k - (255 - v)k/256.
void cmyk_to_rgb(const uint8_t* cmyk, uint8_t* rgb, int w) {
  for (int x = 0; x < w; ++x, cmyk += 4, rgb += 3) {
    const int k = cmyk[3];
    for (int c = 0; c < 3; ++c) rgb[c] = (uint8_t)(k - (((255 - cmyk[c]) * k) >> 8));
  }
}

}  // namespace

extern "C" {

// (height, width) of a JPEG in memory; 0 on success.
int msod_jpeg_size(const uint8_t* data, long n, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = quiet;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to HWC RGB into out (out_h * out_w * 3 bytes); 0 on success, -1
// for a corrupt stream, -2 when the size is not (out_h, out_w).
int msod_jpeg_decode(const uint8_t* data, long n, uint8_t* out, int out_h,
                     int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = quiet;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
                    cinfo.jpeg_color_space == JCS_YCCK;
  cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_height != out_h || (int)cinfo.output_width != out_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const long stride = (long)out_w * 3;
  // a CMYK row goes through this buffer, freed by libjpeg's own pool
  JSAMPARRAY buf = cmyk ? (*cinfo.mem->alloc_sarray)(
      reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE, out_w * 4, 1)
                        : nullptr;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    if (cmyk) {
      jpeg_read_scanlines(&cinfo, buf, 1);
      cmyk_to_rgb(buf[0], row, out_w);
    } else {
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
