// Host image geometry of the port's serving and data paths: resize
// (cv2.INTER_LINEAR and cv2.INTER_AREA), centred pad, affine warp and HSV
// jitter, on HWC RGB uint8 images; and INTER_LINEAR on one-channel float
// maps (Grad-CAM's overlay).
//
// The port's copy of the JAX package's native/image_ops.cpp without its
// JPEG decoder (jpeg_decode.cpp, built only where libjpeg's headers exist),
// so that this library depends on nothing. The two resizes reproduce
// OpenCV's arithmetic for 8-bit three-channel images, so that the port's
// letterbox gives the JAX package's (cv2) pixels where cv2 is absent:
// - INTER_LINEAR: source coordinate (d + 0.5) * scale - 0.5 in float,
//   11-bit fixed-point weights, the horizontal pass in int, the vertical
//   one as OpenCV's vector path computes it ((a >> 4) * b >> 16, twice,
//   + 2 >> 2); x is clamped to the image, y only when rows are fetched;
// - INTER_AREA: integer scale factors average their block (2 x 2 rounds
//   half up, others half to even); other factors use OpenCV's table of
//   float cell weights, summed in float in the same order and rounded half
//   to even.
// Warp and HSV keep the JAX copy's float arithmetic (within a few levels
// of cv2; training's augmentations, not the serving path).
//
// Plain C interface for ctypes; built with g++ by data/native.py.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCoefBits = 11;
constexpr float kCoefScale = 1 << kCoefBits;

inline int16_t round_coef(float v) {
  long r = std::lrintf(v * kCoefScale);  // round half to even, as cvRound
  return (int16_t)std::max(-32768L, std::min(32767L, r));
}

struct AreaCell {
  int d, s;
  float w;
};

// OpenCV's computeResizeAreaTab: the source cells of each destination cell
// with their share of its area.
std::vector<AreaCell> area_tab(int ssize, int dsize, double scale) {
  std::vector<AreaCell> tab;
  for (int d = 0; d < dsize; ++d) {
    double f1 = d * scale, f2 = f1 + scale;
    double cell = std::min(scale, ssize - f1);
    int s1 = (int)std::ceil(f1), s2 = (int)std::floor(f2);
    s2 = std::min(s2, ssize - 1);
    s1 = std::min(s1, s2);
    if (s1 - f1 > 1e-3) tab.push_back({d, s1 - 1, (float)((s1 - f1) / cell)});
    for (int s = s1; s < s2; ++s) tab.push_back({d, s, (float)(1.0 / cell)});
    if (f2 - s2 > 1e-3)
      tab.push_back({d, s2, (float)(std::min(std::min(f2 - s2, 1.), cell) / cell)});
  }
  return tab;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear resize, cv2.INTER_LINEAR
// ---------------------------------------------------------------------------

void msod_resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                          int dh, int dw) {
  const double scale_x = 1.0 / ((double)dw / sw);
  const double scale_y = 1.0 / ((double)dh / sh);
  std::vector<int> xofs(dw);
  std::vector<int16_t> xa(2 * dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (float)((x + 0.5) * scale_x - 0.5);
    int sx = (int)std::floor(fx);
    fx -= sx;
    if (sx < 0) fx = 0, sx = 0;
    if (sx >= sw - 1) fx = 0, sx = sw - 1;
    xofs[x] = sx;
    xa[2 * x] = round_coef(1.f - fx);
    xa[2 * x + 1] = round_coef(fx);
  }
  // horizontal pass of every source row a destination row reads
  std::vector<int> rows((size_t)sh * dw * 3);
  std::vector<char> done(sh, 0);
  auto hrow = [&](int sy) -> const int* {
    int* r = rows.data() + (size_t)sy * dw * 3;
    if (!done[sy]) {
      const uint8_t* s = src + (size_t)sy * sw * 3;
      for (int x = 0; x < dw; ++x) {
        const uint8_t* p0 = s + xofs[x] * 3;
        const uint8_t* p1 = s + std::min(xofs[x] + 1, sw - 1) * 3;
        for (int c = 0; c < 3; ++c)
          r[x * 3 + c] = p0[c] * xa[2 * x] + p1[c] * xa[2 * x + 1];
      }
      done[sy] = 1;
    }
    return r;
  };
  for (int y = 0; y < dh; ++y) {
    float fy = (float)((y + 0.5) * scale_y - 0.5);
    int sy = (int)std::floor(fy);
    fy -= sy;
    const int b0 = round_coef(1.f - fy), b1 = round_coef(fy);
    const int* r0 = hrow(std::min(std::max(sy, 0), sh - 1));
    const int* r1 = hrow(std::min(std::max(sy + 1, 0), sh - 1));
    uint8_t* o = dst + (size_t)y * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      int v = ((((r0[i] >> 4) * b0) >> 16) + (((r1[i] >> 4) * b1) >> 16) + 2) >> 2;
      o[i] = (uint8_t)std::min(std::max(v, 0), 255);
    }
  }
}

// Bilinear resize of a one-channel float image, cv2.INTER_LINEAR on CV_32F:
// the same source coordinates as above with float weights, the horizontal
// pass then the vertical one in float.
void msod_resize_bilinear_f32(const float* src, int sh, int sw, float* dst,
                              int dh, int dw) {
  const double scale_x = 1.0 / ((double)dw / sw);
  const double scale_y = 1.0 / ((double)dh / sh);
  std::vector<int> xofs(dw);
  std::vector<float> xa(2 * dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (float)((x + 0.5) * scale_x - 0.5);
    int sx = (int)std::floor(fx);
    fx -= sx;
    if (sx < 0) fx = 0, sx = 0;
    if (sx >= sw - 1) fx = 0, sx = sw - 1;
    xofs[x] = sx;
    xa[2 * x] = 1.f - fx;
    xa[2 * x + 1] = fx;
  }
  std::vector<float> r0(dw), r1(dw);
  auto hrow = [&](int sy, std::vector<float>& r) {
    const float* s = src + (size_t)sy * sw;
    for (int x = 0; x < dw; ++x)
      r[x] = s[xofs[x]] * xa[2 * x] + s[std::min(xofs[x] + 1, sw - 1)] * xa[2 * x + 1];
  };
  for (int y = 0; y < dh; ++y) {
    float fy = (float)((y + 0.5) * scale_y - 0.5);
    int sy = (int)std::floor(fy);
    fy -= sy;
    const float b0 = 1.f - fy, b1 = fy;
    hrow(std::min(std::max(sy, 0), sh - 1), r0);
    hrow(std::min(std::max(sy + 1, 0), sh - 1), r1);
    float* o = dst + (size_t)y * dw;
    for (int x = 0; x < dw; ++x) o[x] = r0[x] * b0 + r1[x] * b1;
  }
}

// ---------------------------------------------------------------------------
// Area resize for shrinking, cv2.INTER_AREA
// ---------------------------------------------------------------------------

void msod_resize_area(const uint8_t* src, int sh, int sw, uint8_t* dst,
                      int dh, int dw) {
  const double scale_x = 1.0 / ((double)dw / sw);
  const double scale_y = 1.0 / ((double)dh / sh);
  const int isx = (int)std::lround(scale_x), isy = (int)std::lround(scale_y);
  if (std::fabs(scale_x - isx) < DBL_EPSILON &&
      std::fabs(scale_y - isy) < DBL_EPSILON) {
    // 2 x 2 rounds half up (OpenCV's vector path), other factors scale in
    // float and round half to even
    const bool halves = isx == 2 && isy == 2;
    const float inv_area = 1.f / (isx * isy);
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < dw; ++x)
        for (int c = 0; c < 3; ++c) {
          int sum = 0;
          for (int yy = y * isy; yy < (y + 1) * isy; ++yy)
            for (int xx = x * isx; xx < (x + 1) * isx; ++xx)
              sum += src[((size_t)yy * sw + xx) * 3 + c];
          long v = halves ? (sum + 2) >> 2 : std::lrintf(sum * inv_area);
          dst[((size_t)y * dw + x) * 3 + c] = (uint8_t)std::min(v, 255L);
        }
    return;
  }
  const std::vector<AreaCell> xt = area_tab(sw, dw, scale_x);
  const std::vector<AreaCell> yt = area_tab(sh, dh, scale_y);
  std::vector<float> buf((size_t)dw * 3), sum((size_t)dw * 3);
  int prev = -1;
  auto flush = [&](int y) {
    uint8_t* o = dst + (size_t)y * dw * 3;
    for (int i = 0; i < dw * 3; ++i)
      o[i] = (uint8_t)std::min(std::max(std::lrintf(sum[i]), 0L), 255L);
  };
  for (const AreaCell& r : yt) {
    std::fill(buf.begin(), buf.end(), 0.f);
    const uint8_t* s = src + (size_t)r.s * sw * 3;
    for (const AreaCell& c : xt)
      for (int k = 0; k < 3; ++k) buf[c.d * 3 + k] += s[c.s * 3 + k] * c.w;
    if (r.d != prev) {
      if (prev >= 0) flush(prev);
      for (int i = 0; i < dw * 3; ++i) sum[i] = r.w * buf[i];
      prev = r.d;
    } else {
      for (int i = 0; i < dw * 3; ++i) sum[i] += r.w * buf[i];
    }
  }
  if (prev >= 0) flush(prev);
}

// ---------------------------------------------------------------------------
// Letterbox: centered pad to (th, tw) with a gray value
// ---------------------------------------------------------------------------

void msod_pad_center(const uint8_t* src, int sh, int sw, uint8_t* dst, int th,
                     int tw, int top, int left, uint8_t value) {
  std::memset(dst, value, (size_t)th * tw * 3);
  for (int y = 0; y < sh; ++y)
    std::memcpy(dst + ((size_t)(y + top) * tw + left) * 3,
                src + (size_t)y * sw * 3, (size_t)sw * 3);
}

// ---------------------------------------------------------------------------
// Affine warp, inverse-mapped bilinear with a constant border
// (cv2.warpAffine semantics; M maps source to destination)
// ---------------------------------------------------------------------------

void msod_warp_affine(const uint8_t* src, int sh, int sw, const double* M,
                      uint8_t* dst, int dh, int dw, uint8_t border) {
  double a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5];
  double det = a * e - b * d;
  if (std::fabs(det) < 1e-12) det = det < 0 ? -1e-12 : 1e-12;
  double ia = e / det, ib = -b / det, id = -d / det, ie = a / det;
  double ic = -(ia * c + ib * f);
  double iff = -(id * c + ie * f);
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      double sxf = ia * x + ib * y + ic;
      double syf = id * x + ie * y + iff;
      uint8_t* o = dst + ((size_t)y * dw + x) * 3;
      if (sxf < -1 || sxf > sw || syf < -1 || syf > sh) {
        o[0] = o[1] = o[2] = border;
        continue;
      }
      int sx = (int)std::floor(sxf), sy = (int)std::floor(syf);
      float wx = (float)(sxf - sx), wy = (float)(syf - sy);
      for (int ch = 0; ch < 3; ++ch) {
        auto sample = [&](int yy, int xx) -> float {
          if (yy < 0 || yy >= sh || xx < 0 || xx >= sw) return border;
          return src[((size_t)yy * sw + xx) * 3 + ch];
        };
        float v = (1 - wy) * ((1 - wx) * sample(sy, sx) + wx * sample(sy, sx + 1)) +
                  wy * ((1 - wx) * sample(sy + 1, sx) + wx * sample(sy + 1, sx + 1));
        o[ch] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// HSV jitter with gain lookup tables (cv2's 8-bit HSV: H in [0, 180))
// ---------------------------------------------------------------------------

static void rgb2hsv_u8(uint8_t r, uint8_t g, uint8_t b, uint8_t* hh,
                       uint8_t* ss, uint8_t* vv) {
  int mx = std::max({r, g, b}), mn = std::min({r, g, b});
  int s = mx == 0 ? 0 : (int)std::lround(255.0 * (mx - mn) / mx);
  double h = 0;
  if (mx != mn) {
    if (mx == r)
      h = 60.0 * (g - b) / (mx - mn);
    else if (mx == g)
      h = 120 + 60.0 * (b - r) / (mx - mn);
    else
      h = 240 + 60.0 * (r - g) / (mx - mn);
  }
  if (h < 0) h += 360;
  *hh = (uint8_t)(std::lround(h / 2.0) % 180);
  *ss = (uint8_t)s;
  *vv = (uint8_t)mx;
}

static void hsv2rgb_u8(uint8_t h8, uint8_t s8, uint8_t v8, uint8_t* r,
                       uint8_t* g, uint8_t* b) {
  double h = h8 * 2.0, s = s8 / 255.0, v = v8 / 255.0;
  double c = v * s;
  double hp = h / 60.0;
  double xv = c * (1 - std::fabs(std::fmod(hp, 2.0) - 1));
  double r1 = 0, g1 = 0, b1 = 0;
  if (hp < 1) {
    r1 = c; g1 = xv;
  } else if (hp < 2) {
    r1 = xv; g1 = c;
  } else if (hp < 3) {
    g1 = c; b1 = xv;
  } else if (hp < 4) {
    g1 = xv; b1 = c;
  } else if (hp < 5) {
    r1 = xv; b1 = c;
  } else {
    r1 = c; b1 = xv;
  }
  double m = v - c;
  *r = (uint8_t)std::lround((r1 + m) * 255);
  *g = (uint8_t)std::lround((g1 + m) * 255);
  *b = (uint8_t)std::lround((b1 + m) * 255);
}

void msod_hsv_jitter(uint8_t* img, int h, int w, double rh, double rs,
                     double rv) {
  uint8_t lut_h[256], lut_s[256], lut_v[256];
  for (int i = 0; i < 256; ++i) {
    lut_h[i] = (uint8_t)(std::lround(i * rh) % 180);
    lut_s[i] = (uint8_t)std::max(0L, std::min(255L, std::lround(i * rs)));
    lut_v[i] = (uint8_t)std::max(0L, std::min(255L, std::lround(i * rv)));
  }
  const long n = (long)h * w;
  for (long i = 0; i < n; ++i) {
    uint8_t* p = img + i * 3;
    uint8_t hh, ss, vv;
    rgb2hsv_u8(p[0], p[1], p[2], &hh, &ss, &vv);
    hsv2rgb_u8(lut_h[hh], lut_s[ss], lut_v[vv], &p[0], &p[1], &p[2]);
  }
}

}  // extern "C"
