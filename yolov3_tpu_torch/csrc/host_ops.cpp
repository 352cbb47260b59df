// Host image ops of the data pipeline (yolov3_tpu_torch/data/image_ops.py).
//
// Each op reproduces OpenCV's uint8 arithmetic (resize.cpp, imgwarp.cpp,
// color_hsv) so that images decoded and augmented here carry the same bytes
// as the cv2 pipeline of the JAX package, without OpenCV:
//
//   resize_linear_u8     cv2.resize INTER_LINEAR: 11-bit fixed-point taps
//   resize_area_u8       cv2.resize INTER_AREA, downscale: the integer-scale
//                        fast path and the fractional-area tables
//   letterbox_u8         resize_linear_u8 into a canvas filled with a colour
//   warp_affine_u8       cv2.warpAffine / cv2.warpPerspective, INTER_LINEAR,
//   warp_perspective_u8  BORDER_CONSTANT, as OpenCV >= 4.11 computes them:
//                        float32 source positions and fused lerps (older
//                        OpenCV rounds the map to 1/32 px and differs from
//                        these by a few levels)
//   bgr2hsv_u8           cv2.COLOR_BGR2HSV / COLOR_HSV2BGR, 8-bit, hue in
//   hsv2bgr_u8           [0, 180)
//   png_unfilter         PNG row filters 0-4 (the IDAT stream is inflated by
//   png_filter_sub       Python's zlib), and the Sub filter of the encoder
//
// A plain C interface, loaded with ctypes (which releases the GIL for the
// call). Built with -ffp-contract=off: a float step is fused where OpenCV
// fuses it (std::fmaf) and nowhere else.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

inline uint8_t sat_u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// saturate_cast<uchar>(float) / saturate_cast<int>(double): round half to even
inline uint8_t round_u8(float v) { return sat_u8((int)std::nearbyintf(v)); }

inline int round_int(double v) {
  const double r = std::nearbyint(v);
  if (r < (double)INT_MIN) return INT_MIN;
  if (r > (double)INT_MAX) return INT_MAX;
  return (int)r;
}

inline short sat_short(double v) {
  const double r = std::nearbyint(v);
  if (r < -32768.0) return -32768;
  if (r > 32767.0) return 32767;
  return (short)r;
}

const int kResizeBits = 11;  // INTER_RESIZE_COEF_BITS
const int kResizeScale = 1 << kResizeBits;

// Horizontal taps of resize INTER_LINEAR: source offset (in elements) and the
// two 11-bit coefficients of each destination column. Outside the source the
// tap clamps to the edge pixel with weight 1.
void linear_taps_x(int src_len, int dst_len, int cn, std::vector<int>& ofs, std::vector<short>& coef) {
  const double scale = 1.0 / ((double)dst_len / src_len);  // cv2: 1 / inv_scale
  ofs.resize(dst_len);
  coef.resize((size_t)dst_len * 2);
  for (int d = 0; d < dst_len; ++d) {
    float f = (float)((d + 0.5) * scale - 0.5);
    int s = (int)std::floor(f);
    f -= s;
    if (s < 0) s = 0, f = 0.f;
    if (s >= src_len - 1) s = src_len - 1, f = 0.f;
    ofs[d] = s * cn;
    coef[(size_t)d * 2] = sat_short((1.f - f) * kResizeScale);
    coef[(size_t)d * 2 + 1] = sat_short(f * kResizeScale);
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// resize, INTER_LINEAR
// ---------------------------------------------------------------------------

// src (sh, sw, cn) -> dst (dh, dw, cn), row-major uint8.
// Horizontal pass into int rows (coefficients sum to 2048), vertical pass with
// OpenCV's cast ((b0 * (S0 >> 4)) >> 16 + (b1 * (S1 >> 4)) >> 16 + 2) >> 2.
// Vertically the source row index clamps to the image but the weights do not
// (cv2 blends the clamped edge row with itself at the unclamped weights).
void resize_linear_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw) {
  std::vector<int> xofs;
  std::vector<short> xcoef;
  linear_taps_x(sw, dw, cn, xofs, xcoef);
  const double scale_y = 1.0 / ((double)dh / sh);
  const int row = dw * cn;
  std::vector<int> rows((size_t)row * 2);
  int cached[2] = {-1, -1};
  auto hrow = [&](int sy, int slot) {
    if (cached[slot] == sy) return;
    const uint8_t* s = src + (size_t)sy * sw * cn;
    int* d = rows.data() + (size_t)slot * row;
    for (int dx = 0; dx < dw; ++dx) {
      const int sx = xofs[dx];
      const int a0 = xcoef[(size_t)dx * 2], a1 = xcoef[(size_t)dx * 2 + 1];
      const uint8_t* p = s + sx;
      const uint8_t* q = (sx + cn < sw * cn) ? p + cn : p;  // a1 is 0 at the right edge
      for (int c = 0; c < cn; ++c) d[dx * cn + c] = p[c] * a0 + q[c] * a1;
    }
    cached[slot] = sy;
  };
  for (int dy = 0; dy < dh; ++dy) {
    float fy = (float)((dy + 0.5) * scale_y - 0.5);
    int sy = (int)std::floor(fy);
    fy -= sy;
    const int b0 = sat_short((1.f - fy) * kResizeScale), b1 = sat_short(fy * kResizeScale);
    const int y0 = std::min(std::max(sy, 0), sh - 1), y1 = std::min(std::max(sy + 1, 0), sh - 1);
    // parity-keyed two-row cache; equal rows share a slot
    hrow(y0, y0 & 1);
    hrow(y1, y1 & 1);
    const int* S0 = rows.data() + (size_t)(y0 & 1) * row;
    const int* S1 = rows.data() + (size_t)(y1 & 1) * row;
    uint8_t* d = dst + (size_t)dy * row;
    for (int x = 0; x < row; ++x)
      d[x] = sat_u8((((b0 * (S0[x] >> 4)) >> 16) + ((b1 * (S1[x] >> 4)) >> 16) + 2) >> 2);
  }
}

// ---------------------------------------------------------------------------
// resize, INTER_AREA (downscale only: dh <= sh and dw <= sw)
// ---------------------------------------------------------------------------

namespace {

struct AreaTap {
  int di, si;
  float alpha;
};

// cv2 computeResizeAreaTab
std::vector<AreaTap> area_taps(int ssize, int dsize, int cn, double scale) {
  std::vector<AreaTap> tab;
  for (int dx = 0; dx < dsize; ++dx) {
    const double fsx1 = dx * scale, fsx2 = fsx1 + scale;
    const double cell = std::min(scale, ssize - fsx1);
    int sx1 = (int)std::ceil(fsx1), sx2 = (int)std::floor(fsx2);
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3) tab.push_back({dx * cn, (sx1 - 1) * cn, (float)((sx1 - fsx1) / cell)});
    for (int sx = sx1; sx < sx2; ++sx) tab.push_back({dx * cn, sx * cn, (float)(1.0 / cell)});
    if (fsx2 - sx2 > 1e-3)
      tab.push_back({dx * cn, sx2 * cn, (float)(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
  }
  return tab;
}

}  // namespace

void resize_area_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw) {
  const double scale_x = 1.0 / ((double)dw / sw), scale_y = 1.0 / ((double)dh / sh);
  const int ix = (int)std::nearbyint(scale_x), iy = (int)std::nearbyint(scale_y);
  const bool fast = std::fabs(scale_x - ix) < 2.220446049250313e-16 &&
                    std::fabs(scale_y - iy) < 2.220446049250313e-16;
  const int row = dw * cn;
  if (fast) {  // integer scale: the mean of each ix x iy cell
    const int area = ix * iy;
    const float inv = 1.f / area;
    const int full = (sw / ix) * cn;  // elements of whole cells in a row
    for (int dy = 0; dy < dh; ++dy) {
      uint8_t* d = dst + (size_t)dy * row;
      const int sy0 = dy * iy;
      const int w = (sy0 + iy <= sh) ? full : 0;
      int dx = 0;
      for (; dx < w; ++dx) {
        const int sx0 = (dx / cn) * ix * cn + dx % cn;
        int sum = 0;
        for (int ky = 0; ky < iy; ++ky) {
          const uint8_t* s = src + (size_t)(sy0 + ky) * sw * cn + sx0;
          for (int kx = 0; kx < ix; ++kx) sum += s[kx * cn];
        }
        // the 2x2 case has its own rounding, (sum + 2) >> 2
        d[dx] = (ix == 2 && iy == 2) ? (uint8_t)((sum + 2) >> 2) : round_u8(sum * inv);
      }
      for (; dx < row; ++dx) {  // cells cut by the image edge
        const int sx0 = (dx / cn) * ix * cn + dx % cn;
        int sum = 0, count = 0;
        for (int ky = 0; ky < iy && sy0 + ky < sh; ++ky)
          for (int kx = 0; kx < ix * cn && sx0 + kx < sw * cn; kx += cn) {
            sum += src[(size_t)(sy0 + ky) * sw * cn + sx0 + kx];
            ++count;
          }
        d[dx] = count ? round_u8((float)sum / count) : 0;
      }
    }
    return;
  }
  const std::vector<AreaTap> xt = area_taps(sw, dw, cn, scale_x);
  const std::vector<AreaTap> yt = area_taps(sh, dh, 1, scale_y);
  std::vector<float> buf(row), sum(row, 0.f);
  int prev_dy = yt.empty() ? 0 : yt[0].di;
  for (const AreaTap& t : yt) {
    const float beta = t.alpha;
    const uint8_t* s = src + (size_t)t.si * sw * cn;
    std::fill(buf.begin(), buf.end(), 0.f);
    for (const AreaTap& x : xt)
      for (int c = 0; c < cn; ++c) buf[x.di + c] = buf[x.di + c] + s[x.si + c] * x.alpha;
    if (t.di != prev_dy) {
      uint8_t* d = dst + (size_t)prev_dy * row;
      for (int i = 0; i < row; ++i) {
        d[i] = round_u8(sum[i]);
        sum[i] = beta * buf[i];
      }
      prev_dy = t.di;
    } else {
      for (int i = 0; i < row; ++i) sum[i] += beta * buf[i];
    }
  }
  uint8_t* d = dst + (size_t)prev_dy * row;
  for (int i = 0; i < row; ++i) d[i] = round_u8(sum[i]);
}

// ---------------------------------------------------------------------------
// letterbox: resize to (rh, rw) and place at (top, left) in a (dh, dw) canvas
// ---------------------------------------------------------------------------

void letterbox_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw, int rh, int rw,
                  int top, int left, const uint8_t* color) {
  for (int x = 0; x < dw; ++x)
    for (int c = 0; c < cn; ++c) dst[x * cn + c] = color[c];
  for (int y = 1; y < dh; ++y) std::memcpy(dst + (size_t)y * dw * cn, dst, (size_t)dw * cn);
  const uint8_t* img = src;
  std::vector<uint8_t> resized;
  if (rh != sh || rw != sw) {
    resized.resize((size_t)rh * rw * cn);
    resize_linear_u8(src, sh, sw, cn, resized.data(), rh, rw);
    img = resized.data();
  }
  for (int y = 0; y < rh; ++y)
    std::memcpy(dst + ((size_t)(y + top) * dw + left) * cn, img + (size_t)y * rw * cn, (size_t)rw * cn);
}

// ---------------------------------------------------------------------------
// warpAffine / warpPerspective, INTER_LINEAR + BORDER_CONSTANT
// ---------------------------------------------------------------------------

namespace {

// One destination pixel at source position (sx, sy), as OpenCV's float32
// warp kernels compute it (the ones of OpenCV >= 4.11): taps outside the
// image read the border value, two fused lerps along x, one along y, then
// round half to even.
inline void warp_pixel(const uint8_t* src, int sh, int sw, int cn, float sx, float sy, const uint8_t* cval,
                       uint8_t* d) {
  if (!(sx > -2.f && sx < (float)sw + 1.f && sy > -2.f && sy < (float)sh + 1.f)) {  // no tap inside (or NaN)
    for (int c = 0; c < cn; ++c) d[c] = cval[c];
    return;
  }
  const float fx = std::floor(sx), fy = std::floor(sy);
  const float ax = sx - fx, ay = sy - fy;
  const long ix = (long)fx, iy = (long)fy;
  const bool x0in = ix >= 0 && ix < sw, x1in = ix + 1 >= 0 && ix + 1 < sw;
  const bool y0in = iy >= 0 && iy < sh, y1in = iy + 1 >= 0 && iy + 1 < sh;
  auto tap = [&](bool in, long y, long x, int c) -> float { return in ? src[(y * sw + x) * cn + c] : cval[c]; };
  for (int c = 0; c < cn; ++c) {
    const float p00 = tap(y0in && x0in, iy, ix, c), p01 = tap(y0in && x1in, iy, ix + 1, c);
    const float p10 = tap(y1in && x0in, iy + 1, ix, c), p11 = tap(y1in && x1in, iy + 1, ix + 1, c);
    const float v0 = std::fmaf(ax, p01 - p00, p00);
    const float v1 = std::fmaf(ax, p11 - p10, p10);
    d[c] = round_u8(std::fmaf(ay, v1 - v0, v0));
  }
}

}  // namespace

// m: the forward 2x3 matrix (src -> dst), as given to cv2.warpAffine. It is
// inverted in double as cv2 does, then used in float32: the row term
// y * m1 + m2 rounded twice, the column term fused onto it.
void warp_affine_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw, const double* m,
                    const uint8_t* cval) {
  double M[6] = {m[0], m[1], m[2], m[3], m[4], m[5]};
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1. / D : 0;
  const double A11 = M[4] * D, A22 = M[0] * D;
  M[0] = A11;
  M[1] *= -D;
  M[3] *= -D;
  M[4] = A22;
  const double b1 = -M[0] * M[2] - M[1] * M[5];
  const double b2 = -M[3] * M[2] - M[4] * M[5];
  M[2] = b1;
  M[5] = b2;
  float F[6];
  for (int i = 0; i < 6; ++i) F[i] = (float)M[i];
  for (int y = 0; y < dh; ++y) {
    const float rx = (float)y * F[1] + F[2], ry = (float)y * F[4] + F[5];
    uint8_t* d = dst + (size_t)y * dw * cn;
    for (int x = 0; x < dw; ++x)
      warp_pixel(src, sh, sw, cn, std::fmaf((float)x, F[0], rx), std::fmaf((float)x, F[3], ry), cval,
                 d + (size_t)x * cn);
  }
}

// m: the forward 3x3 matrix (src -> dst), as given to cv2.warpPerspective.
void warp_perspective_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw,
                         const double* m, const uint8_t* cval) {
  // cv::invert (DECOMP_LU) of a 3x3 double matrix: the cofactor formula
  auto S = [&](int i, int j) { return m[i * 3 + j]; };
  const double det = S(0, 0) * (S(1, 1) * S(2, 2) - S(1, 2) * S(2, 1)) -
                     S(0, 1) * (S(1, 0) * S(2, 2) - S(1, 2) * S(2, 0)) +
                     S(0, 2) * (S(1, 0) * S(2, 1) - S(1, 1) * S(2, 0));
  double M[9] = {0};
  if (det != 0.) {
    const double d = 1. / det;
    M[0] = (S(1, 1) * S(2, 2) - S(1, 2) * S(2, 1)) * d;
    M[1] = (S(0, 2) * S(2, 1) - S(0, 1) * S(2, 2)) * d;
    M[2] = (S(0, 1) * S(1, 2) - S(0, 2) * S(1, 1)) * d;
    M[3] = (S(1, 2) * S(2, 0) - S(1, 0) * S(2, 2)) * d;
    M[4] = (S(0, 0) * S(2, 2) - S(0, 2) * S(2, 0)) * d;
    M[5] = (S(0, 2) * S(1, 0) - S(0, 0) * S(1, 2)) * d;
    M[6] = (S(1, 0) * S(2, 1) - S(1, 1) * S(2, 0)) * d;
    M[7] = (S(0, 1) * S(2, 0) - S(0, 0) * S(2, 1)) * d;
    M[8] = (S(0, 0) * S(1, 1) - S(0, 1) * S(1, 0)) * d;
  }
  float F[9];
  for (int i = 0; i < 9; ++i) F[i] = (float)M[i];
  for (int y = 0; y < dh; ++y) {
    const float rx = (float)y * F[1] + F[2], ry = (float)y * F[4] + F[5], rw = (float)y * F[7] + F[8];
    uint8_t* d = dst + (size_t)y * dw * cn;
    for (int x = 0; x < dw; ++x) {
      const float w = std::fmaf((float)x, F[6], rw);
      warp_pixel(src, sh, sw, cn, std::fmaf((float)x, F[0], rx) / w, std::fmaf((float)x, F[3], ry) / w, cval,
                 d + (size_t)x * cn);
    }
  }
}

// ---------------------------------------------------------------------------
// BGR <-> HSV, 8-bit (H in [0, 180))
// ---------------------------------------------------------------------------

namespace {

const int kHsvShift = 12;

struct HsvTables {  // cv2's division tables: 255 / v and 180 / (6 * diff) in 12-bit fixed point
  int sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = round_int((255 << kHsvShift) / (1. * i));
      hdiv[i] = round_int((180 << kHsvShift) / (6. * i));
    }
  }
};
const HsvTables kHsv;

}  // namespace

void bgr2hsv_u8(const uint8_t* src, uint8_t* dst, long n) {
  const int shift = kHsvShift;
  const int* sdiv = kHsv.sdiv;
  const int* hdiv = kHsv.hdiv;
  for (long i = 0; i < n; ++i, src += 3, dst += 3) {
    const int b = src[0], g = src[1], r = src[2];
    const int v = std::max(b, std::max(g, r));
    const int vmin = std::min(b, std::min(g, r));
    const int diff = v - vmin;
    const int vr = v == r ? -1 : 0, vg = v == g ? -1 : 0;
    const int s = (diff * sdiv[v] + (1 << (shift - 1))) >> shift;
    int h = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff)) + ((~vg) & (r - g + 4 * diff))));
    h = (h * hdiv[diff] + (1 << (shift - 1))) >> shift;
    h += h < 0 ? 180 : 0;
    dst[0] = sat_u8(h);
    dst[1] = (uint8_t)s;
    dst[2] = (uint8_t)v;
  }
}

// OpenCV converts a row's first multiple of kHsvVector pixels on its vector
// path, which truncates the final value, and the rest on its scalar path,
// which rounds it (OpenCV's AVX2 build: 32 uint8 lanes). Both fuse s * h
// into 1 - s * h.
const int kHsvVector = 32;

void hsv2bgr_u8(const uint8_t* src, uint8_t* dst, long rows, int width) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.f / 180;
  const int vec_end = width / kHsvVector * kHsvVector;
  for (long y = 0; y < rows; ++y) {
    for (int x = 0; x < width; ++x, src += 3, dst += 3) {
      float h = src[0];
      const float s = src[1] * (1.0f / 255.0f), v = src[2] * (1.0f / 255.0f);
      float b, g, r;
      if (s == 0) {
        b = g = r = v;
      } else {
        h *= hscale;
        h = std::fmod(h, 6.f);
        int sector = (int)std::floor(h);
        h -= sector;
        if ((unsigned)sector >= 6u) sector = 0, h = 0.f;
        const float tab[4] = {v, v * (1.f - s), v * std::fmaf(-s, h, 1.f), v * std::fmaf(-s, 1.f - h, 1.f)};
        b = tab[sector_data[sector][0]];
        g = tab[sector_data[sector][1]];
        r = tab[sector_data[sector][2]];
      }
      if (x < vec_end) {
        dst[0] = sat_u8((int)(b * 255.0f));
        dst[1] = sat_u8((int)(g * 255.0f));
        dst[2] = sat_u8((int)(r * 255.0f));
      } else {
        dst[0] = round_u8(b * 255.0f);
        dst[1] = round_u8(g * 255.0f);
        dst[2] = round_u8(r * 255.0f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PNG row filters
// ---------------------------------------------------------------------------

// raw: h rows of (1 filter byte + stride bytes), the inflated IDAT stream;
// out: h * stride bytes. bpp: bytes per pixel. Returns 0, or -1 on a bad
// filter type.
int png_unfilter(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + (size_t)y * (stride + 1);
    const int ft = in[0];
    ++in;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* up = y ? cur - stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          cur[i] = (uint8_t)(in[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// img: h rows of stride bytes -> out: h rows of (filter byte 1 + Sub residuals).
void png_filter_sub(const uint8_t* img, int h, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* cur = img + (size_t)y * stride;
    uint8_t* o = out + (size_t)y * (stride + 1);
    o[0] = 1;
    for (int i = 0; i < stride; ++i) o[i + 1] = (uint8_t)(cur[i] - (i >= bpp ? cur[i - bpp] : 0));
  }
}


// ---------------------------------------------------------------------------
// JPEG decoding (cv2.imread / cv2.imdecode of an 8-bit Huffman-coded JPEG)
// ---------------------------------------------------------------------------
//
// Decodes as libjpeg-turbo does with the defaults OpenCV leaves in place:
// the integer "islow" IDCT (jidctint.c) with 13-bit constants, fancy
// upsampling (jdsample.c: h2v1 (3a+b+1)>>2 / (3a+b+2)>>2, h1v2 with biases 1
// and 2, h2v2 (3*colsum+neighbour+8)>>4 / +7>>4; other integral factors
// replicate), the fixed-point YCbCr->RGB tables of jdcolor.c (16 fraction
// bits, ONE_HALF rounding) and BGR output; gray is replicated to 3 channels.
// Baseline, extended-sequential and progressive Huffman scans, 1 or 3
// components, any integral sampling factors, restart intervals, interleaved
// and non-interleaved scans. All coefficients are buffered for the whole
// image, then transformed and converted.
//
// A stream that ends early decodes as libjpeg's: bits past the end read as
// zeros for the block being decoded, then every later block of that data
// segment keeps zero coefficients (uniform gray). A progressive image whose
// first ten coefficients are not all complete is refused: libjpeg smooths
// such blocks (jdcoefct.c decompress_smooth_data), which is not reproduced.

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void jfail(const std::string& m) { throw JpegError{m}; }

const uint64_t kMaxPixels = uint64_t(1) << 30;

// SOFn markers: the three decoded here return; every other frame kind raises, naming it
bool is_sof(int m) { return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC; }

void check_sof_kind(int m) {
  if (m == 0xC3) jfail("lossless JPEG is not supported");
  if (m >= 0xC5 && m <= 0xC7) jfail("hierarchical JPEG is not supported");
  if (m >= 0xC9) jfail("arithmetic-coded JPEG is not supported");
}

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t val[256];
  int look_nbits[256];
  uint8_t look_sym[256];
};

void build_huff(Huff& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  std::memcpy(h.val, vals, nvals);
  int code = 0, p = 0;
  int huffcode[257], huffsize[257];
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) jfail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      h.valoffset[l] = p - huffcode[p];
      p += bits[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; ++i) h.look_nbits[i] = 0;
  p = 0;
  for (int l = 1; l <= 8; ++l)
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      const int lookbits = huffcode[p] << (8 - l);
      for (int c = 0; c < (1 << (8 - l)); ++c) {
        h.look_nbits[lookbits + c] = l;
        h.look_sym[lookbits + c] = vals[p];
      }
    }
  h.defined = true;
}

struct Comp {
  int id, h, v, tq, td = 0, ta = 0;
  int bw, bh;      // blocks that hold image samples (width_in_blocks, height_in_blocks)
  int aw, ah;      // allocated blocks (padded to whole MCUs)
  int dw, dh;      // downsampled width and height in samples
  int coef_bits[64];
  std::vector<int16_t> coef;
  int dc_pred;
};

struct Jpeg {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1, restart_interval = 0, orientation = 1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Comp comp[4];
  // entropy state
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;           // a marker met inside entropy data (0xD9 at the end of the data)
  bool insufficient = false, any_insufficient = false;
  int eobrun = 0;

  int u8() {
    if (pos >= n) jfail("unexpected end of data in a marker segment");
    return d[pos++];
  }
  int u16() {
    const int a = u8();
    return (a << 8) | u8();
  }

  // -- bit reader (jdhuff.c jpeg_fill_bit_buffer) ---------------------------
  void fill() {
    while (bits <= 56 && !marker) {
      if (pos >= n) {
        marker = 0xD9;  // the source manager's fake EOI
        break;
      }
      int c = d[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= n) {
            c = -1;
            break;
          }
          c = d[pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c < 0 ? 0xD9 : c;
          if (c > 0) pos -= 2;  // leave the marker in the stream
          break;
        }
      }
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }
  // make n bits available, zero-filling past the end of the segment
  inline void need(int k) {
    if (bits < k) {
      fill();
      if (bits < k) {
        insufficient = any_insufficient = true;
        bits = 64;  // the rest of buf is zeros already
      }
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    need(k);
    const int r = (int)(buf >> (64 - k));
    buf <<= k;
    bits -= k;
    return r;
  }
  inline int get1() { return get(1); }
  int decode(const Huff& h) {
    if (bits < 8) fill();
    if (bits >= 8) {
      const int look = (int)(buf >> 56);
      const int nb = h.look_nbits[look];
      if (nb) {
        buf <<= nb;
        bits -= nb;
        return h.look_sym[look];
      }
    }
    int l = 1, code = get1();
    while (l <= 16 && code > h.maxcode[l]) {
      code = (code << 1) | get1();
      ++l;
    }
    if (l > 16) return 0;  // bad code: libjpeg fakes a zero
    return h.val[(code + h.valoffset[l]) & 0xFF];
  }
  static inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (-(1 << s) + 1) : r; }

  // -- markers ---------------------------------------------------------------
  int next_marker() {
    // skip to the next 0xFF xx (xx not 0, not 0xFF)
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      if (pos >= n) return 0xD9;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return 0xD9;
      const int c = d[pos++];
      if (c != 0) return c;
    }
  }

  void read_sof(int kind) {
    if (have_frame) jfail("more than one frame");
    const int len = u16();
    const int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) jfail(std::to_string(precision) + "-bit samples are not supported (8-bit only)");
    if (height == 0) jfail("image height given by a DNL marker is not supported");
    if (width == 0) jfail("zero image width");
    // OpenCV's validateInputImageSize (CV_IO_MAX_IMAGE_PIXELS), checked before anything is allocated
    if ((uint64_t)width * height > kMaxPixels)
      jfail(std::to_string(width) + "x" + std::to_string(height) + " image exceeds the limit of 2^30 pixels");
    if (ncomp != 1 && ncomp != 3)
      jfail(std::to_string(ncomp) + "-component images (CMYK / YCCK) are not supported");
    if (len != 8 + 3 * ncomp) jfail("bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) jfail("bad sampling factors or table");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) jfail("fractional sampling factors are not supported");
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.aw = mcux * c.h;
      c.ah = mcuy * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    progressive = kind == 0xC2;
    have_frame = true;
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      const int tc_th = u8();
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256 || (tc_th & 15) > 3 || (tc_th >> 4) > 1) jfail("bad DHT segment");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = (uint8_t)u8();
      build_huff((tc_th >> 4) ? ac[tc_th & 15] : dc[tc_th & 15], counts, vals, total);
      len -= 17 + total;
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq_tq = u8();
      const int t = pq_tq & 15, prec = pq_tq >> 4;
      if (t > 3) jfail("bad DQT segment");
      for (int k = 0; k < 64; ++k) qt[t][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[t] = true;
      len -= 65 + 64 * prec;
    }
  }

  void read_app(int kind) {
    const int len = u16();
    const size_t start = pos, end = start + len - 2;
    if (end > n) jfail("truncated marker segment");
    if (kind == 0xE0 && len >= 7 && !std::memcmp(d + start, "JFIF\0", 5)) jfif = true;
    if (kind == 0xEE && len >= 14 && !std::memcmp(d + start, "Adobe", 5)) {
      adobe = true;
      adobe_transform = d[start + 11];
    }
    if (kind == 0xE1 && len >= 16 && !std::memcmp(d + start, "Exif\0\0", 6) && orientation == 1) exif(start + 6, end);
    pos = end;
  }

  // EXIF IFD0 tag 0x0112 (orientation), as OpenCV's ExifReader reads it
  void exif(size_t t, size_t end) {
    if (t + 8 > end) return;
    const bool le = d[t] == 'I';
    auto r16 = [&](size_t p) { return le ? d[p] | (d[p + 1] << 8) : (d[p] << 8) | d[p + 1]; };
    auto r32 = [&](size_t p) {
      return le ? (uint32_t)d[p] | ((uint32_t)d[p + 1] << 8) | ((uint32_t)d[p + 2] << 16) | ((uint32_t)d[p + 3] << 24)
                : ((uint32_t)d[p] << 24) | ((uint32_t)d[p + 1] << 16) | ((uint32_t)d[p + 2] << 8) | d[p + 3];
    };
    const size_t ifd = t + r32(t + 4);
    if (ifd + 2 > end) return;
    const int count = r16(ifd);
    for (int i = 0; i < count; ++i) {
      const size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > end) return;
      if (r16(e) == 0x0112) {
        const int v = r16(e + 8);
        orientation = (v >= 1 && v <= 8) ? v : 1;
        return;
      }
    }
  }

  // -- scans -----------------------------------------------------------------
  void reset_entropy() {
    buf = 0;
    bits = 0;
    eobrun = 0;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
  }

  // at a restart boundary (jdhuff.c process_restart + jdmarker.c read_restart_marker)
  void restart(int& next_rst) {
    buf = 0;
    bits = 0;
    if (!marker) {
      // find the marker, discarding any garbage before it
      const int m = next_marker();
      marker = m;
      if (m != 0xD9) pos -= 2;
    }
    if (marker == 0xD0 + next_rst) {
      pos += 2;
      marker = 0;
      insufficient = false;
    } else if (marker >= 0xD0 && marker <= 0xD7) {
      // a restart marker out of sequence: libjpeg's resync (action 1/2), simplified
      pos += 2;
      marker = 0;
      insufficient = false;
    }  // another marker: the rest of the scan reads as empty segments
    next_rst = (next_rst + 1) & 7;
    eobrun = 0;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
  }

  inline int16_t* block(Comp& c, int by, int bx) { return c.coef.data() + ((size_t)by * c.aw + bx) * 64; }

  void decode_block_baseline(Comp& c, int16_t* b) {
    int s = decode(dc[c.td]);
    if (s) s = extend(get(s), s);
    c.dc_pred += s;
    b[0] = (int16_t)c.dc_pred;
    const Huff& t = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = decode(t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        b[kNatural[k]] = (int16_t)extend(get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void read_sos() {
    if (!have_frame) jfail("scan before the frame header");
    // coefficients are allocated at the first scan, so that jpeg_info allocates nothing
    for (int i = 0; i < ncomp; ++i)
      if (comp[i].coef.empty()) comp[i].coef.assign((size_t)comp[i].aw * comp[i].ah * 64, 0);
    const int len = u16();
    const int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) jfail("bad SOS segment");
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), tables = u8();
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) jfail("scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3) jfail("bad Huffman table number");
      sc[i] = c;
    }
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13)
        jfail("bad progressive scan parameters");
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    } else {
      for (int i = 0; i < ns; ++i)
        for (int k = 0; k < 64; ++k) sc[i]->coef_bits[k] = 0;
    }
    for (int i = 0; i < ns; ++i) {
      if (!qt_defined[sc[i]->tq]) jfail("quantization table not defined");
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;  // AC refinement decodes with its table too (jdphuff.c)
      if ((need_dc && !dc[sc[i]->td].defined) || (need_ac && !ac[sc[i]->ta].defined))
        jfail("Huffman table not defined");
    }
    reset_entropy();
    marker = 0;
    insufficient = false;
    int mx, my;
    if (ns == 1) {
      mx = sc[0]->bw;
      my = sc[0]->bh;
    } else {
      mx = mcux;
      my = mcuy;
    }
    const long total = (long)mx * my;
    int next_rst = 0;
    long todo = restart_interval;
    for (long m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && todo == 0) {
        restart(next_rst);
        todo = restart_interval;
      }
      const int row = (int)(m / mx), col = (int)(m % mx);
      if (!insufficient) {
        if (ns == 1) {
          decode_mcu(sc, 1, ss, se, ah, al, row, col, true);
        } else {
          decode_mcu(sc, ns, ss, se, ah, al, row, col, false);
        }
      }
      if (restart_interval) --todo;
    }
    // leave the stream at the next marker
    if (marker && marker != 0xD9) {
      // pos already points at the 0xFF of the marker
    } else if (!marker) {
      // skip any padding bits / bytes up to the next marker
      const int m = next_marker();
      if (m != 0xD9 || pos < n) pos -= 2;
      if (pos > n) pos = n;
    }
  }

  void decode_mcu(Comp** sc, int ns, int ss, int se, int ah, int al, int row, int col, bool single) {
    if (!progressive) {
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        if (single) {
          decode_block_baseline(c, block(c, row, col));
        } else {
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) decode_block_baseline(c, block(c, row * c.v + v, col * c.h + h));
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans, interleaved or not
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        const int nv = single ? 1 : c.v, nh = single ? 1 : c.h;
        for (int v = 0; v < nv; ++v)
          for (int h = 0; h < nh; ++h) {
            int16_t* b = single ? block(c, row, col) : block(c, row * c.v + v, col * c.h + h);
            if (ah == 0) {
              int s = decode(dc[c.td]);
              if (s) s = extend(get(s), s);
              c.dc_pred += s;
              b[0] = (int16_t)(c.dc_pred * (1 << al));
            } else if (get1()) {
              b[0] |= (int16_t)(1 << al);
            }
          }
      }
      return;
    }
    Comp& c = *sc[0];
    int16_t* b = block(c, row, col);
    const Huff& t = ac[c.ta];
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = (int16_t)(extend(get(s), s) * (1 << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get1() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get(r);
          break;
        }
        do {
          int16_t& co = b[kNatural[k]];
          if (co != 0) {
            if (get1() && (co & p1) == 0) co = (int16_t)(co >= 0 ? co + p1 : co + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& co = b[kNatural[k]];
        if (co != 0 && get1() && (co & p1) == 0) co = (int16_t)(co >= 0 ? co + p1 : co + m1);
      }
      --eobrun;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) jfail("not a JPEG file");
    pos = 2;
    for (;;) {
      if (pos >= n) break;  // no EOI: libjpeg warns and ends the image
      int m;
      if (d[pos] != 0xFF) {
        m = next_marker();  // garbage between segments
      } else {
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) break;
        m = d[pos++];
      }
      if (m == 0xD9) break;
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (is_sof(m)) {
        check_sof_kind(m);
        read_sof(m);
        continue;
      }
      switch (m) {
        case 0xCC:
          jfail("arithmetic-coded JPEG is not supported");  // DAC: arithmetic-coding conditioning
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          if (u16() != 4) jfail("bad DRI segment");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos();
          break;
        case 0xDC:
          jfail("DNL marker is not supported");
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else {
            const int len = u16();
            if (len < 2 || pos + len - 2 > n) jfail("truncated marker segment");
            pos += len - 2;
          }
      }
    }
    if (!have_frame) jfail("JPEG without a frame header");
    if (ncomp == 3) {
      const bool rgb = jfif ? false
                       : adobe ? adobe_transform == 0
                               : (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
      if (rgb) jfail("RGB-coded JPEG (Adobe transform 0) is not supported");
    }
    for (int i = 0; i < ncomp; ++i) {
      if (comp[i].coef_bits[0] < 0) jfail("a component has no DC scan");
      if (progressive)
        for (int k = 1; k < 10; ++k)
          if (comp[i].coef_bits[k] != 0)
            jfail("incomplete progressive JPEG (libjpeg's block smoothing) is not supported");
    }
  }
};

// jidctint.c jpeg_idct_islow, one 8x8 block into `out` (row stride `stride`)
const int kConstBits = 13, kPass1Bits = 2;

inline uint8_t idct_limit(long x) {
  // range_limit[x & RANGE_MASK] of jdmaster.c for |x| < 512 (saturating, as libjpeg-turbo's SIMD IDCT)
  x += 128;
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  long ws[64];
  auto descale = [](long x, int nb) { return (x + (1L << (nb - 1))) >> nb; };
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    long* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const long dcval = (long)(ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    long z2 = (long)ip[16] * qp[16], z3 = (long)ip[48] * qp[48];
    long z1 = (z2 + z3) * 4433;
    long tmp2 = z1 + z3 * -15137;
    long tmp3 = z1 + z2 * 6270;
    z2 = (long)ip[0] * qp[0];
    z3 = (long)ip[32] * qp[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (long)ip[56] * qp[56];
    tmp1 = (long)ip[40] * qp[40];
    tmp2 = (long)ip[24] * qp[24];
    tmp3 = (long)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    const long z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int nb = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, nb);
    wp[56] = descale(tmp10 - tmp3, nb);
    wp[8] = descale(tmp11 + tmp2, nb);
    wp[48] = descale(tmp11 - tmp2, nb);
    wp[16] = descale(tmp12 + tmp1, nb);
    wp[40] = descale(tmp12 - tmp1, nb);
    wp[24] = descale(tmp13 + tmp0, nb);
    wp[32] = descale(tmp13 - tmp0, nb);
  }
  for (int r = 0; r < 8; ++r) {
    const long* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int nb = kConstBits + kPass1Bits + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * 4433;
    long tmp2 = z1 + z3 * -15137;
    long tmp3 = z1 + z2 * 6270;
    long tmp0 = (wp[0] + wp[4]) * (1L << kConstBits);
    long tmp1 = (wp[0] - wp[4]) * (1L << kConstBits);
    const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    const long z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, nb));
    op[7] = idct_limit(descale(tmp10 - tmp3, nb));
    op[1] = idct_limit(descale(tmp11 + tmp2, nb));
    op[6] = idct_limit(descale(tmp11 - tmp2, nb));
    op[2] = idct_limit(descale(tmp12 + tmp1, nb));
    op[5] = idct_limit(descale(tmp12 - tmp1, nb));
    op[3] = idct_limit(descale(tmp13 + tmp0, nb));
    op[4] = idct_limit(descale(tmp13 - tmp0, nb));
  }
}

// One component's samples upsampled to the full image grid (jdsample.c), as
// rows of `width` samples; rows and columns past the component's downsampled
// size read its last row and column, as libjpeg's context rows do.
std::vector<uint8_t> upsample(const Jpeg& j, const Comp& c, const std::vector<uint8_t>& plane) {
  const int pw = c.aw * 8;  // plane stride
  const int W = j.width, H = j.height;
  const int he = j.hmax / c.h, ve = j.vmax / c.v;
  std::vector<uint8_t> out((size_t)W * H);
  auto at = [&](int y, int x) { return (int)plane[(size_t)y * pw + x]; };
  auto clampy = [&](int y) { return y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y); };
  if (he == 1 && ve == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(&out[(size_t)y * W], &plane[(size_t)y * pw], W);
    return out;
  }
  const bool fancy_h2 = c.dw > 2;
  if (he == 2 && ve == 1 && fancy_h2) {
    std::vector<uint8_t> row((size_t)2 * c.dw);
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = &plane[(size_t)y * pw];
      uint8_t* o = row.data();
      int v = in[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < c.dw - 1; ++x) {
        v = in[x] * 3;
        *o++ = (uint8_t)((v + in[x - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      v = in[c.dw - 1];
      *o++ = (uint8_t)((v * 3 + in[c.dw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
      std::memcpy(&out[(size_t)y * W], row.data(), W);
    }
    return out;
  }
  if (he == 1 && ve == 2) {
    for (int y = 0; y < H; ++y) {
      const int iy = y >> 1;
      const bool upper = (y & 1) == 0;
      const int ny = clampy(upper ? iy - 1 : iy + 1);
      const int bias = upper ? 1 : 2;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((at(iy, x) * 3 + at(ny, x) + bias) >> 2);
    }
    return out;
  }
  if (he == 2 && ve == 2 && fancy_h2) {
    std::vector<uint8_t> row((size_t)2 * c.dw);
    std::vector<int> cs(c.dw);
    for (int y = 0; y < H; ++y) {
      const int iy = y >> 1;
      const int ny = clampy((y & 1) == 0 ? iy - 1 : iy + 1);
      for (int x = 0; x < c.dw; ++x) cs[x] = at(iy, x) * 3 + at(ny, x);
      uint8_t* o = row.data();
      *o++ = (uint8_t)((cs[0] * 4 + 8) >> 4);
      *o++ = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int x = 1; x < c.dw - 1; ++x) {
        *o++ = (uint8_t)((cs[x] * 3 + cs[x - 1] + 8) >> 4);
        *o++ = (uint8_t)((cs[x] * 3 + cs[x + 1] + 7) >> 4);
      }
      *o++ = (uint8_t)((cs[c.dw - 1] * 3 + cs[c.dw - 2] + 8) >> 4);
      *o++ = (uint8_t)((cs[c.dw - 1] * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)y * W], row.data(), W);
    }
    return out;
  }
  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
  for (int y = 0; y < H; ++y) {
    uint8_t* o = &out[(size_t)y * W];
    const int iy = y / ve;
    for (int x = 0; x < W; ++x) o[x] = (uint8_t)at(iy, x / he);
  }
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const long one_half = 1L << 15;
    auto fix = [](double x) { return (long)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

}  // namespace

// JPEG header: size, components and EXIF orientation. Returns 0, or -1 with
// the reason in err.
int jpeg_info(const uint8_t* data, long size, int* info, char* err, int errlen) {
  try {
    Jpeg j;
    j.d = data;
    j.n = (size_t)size;
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) jfail("not a JPEG file");
    j.pos = 2;
    while (!j.have_frame) {
      if (j.pos >= j.n) jfail("JPEG without a frame header");
      const int m = j.next_marker();
      if (m == 0xD9) jfail("JPEG without a frame header");
      if (is_sof(m)) {
        check_sof_kind(m);
        j.read_sof(m);
      } else if (m >= 0xE0 && m <= 0xEF) {
        j.read_app(m);
      } else if (!(m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7))) {
        const int len = j.u16();
        j.pos += len - 2;
      }
    }
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    info[3] = j.orientation;
    return 0;
  } catch (const JpegError& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
    return -1;
  } catch (const std::exception& e) {
    std::snprintf(err, errlen, "JPEG decode failed: %s", e.what());
    return -1;
  } catch (...) {
    std::snprintf(err, errlen, "JPEG decode failed");
    return -1;
  }
}

// Decode to BGR (height, width, 3) into `out` (the size jpeg_info gives,
// before orientation). Returns 0, 1 when the entropy data ended early (the
// image is still whole, as libjpeg's), or -1 with the reason in err.
int jpeg_decode_bgr(const uint8_t* data, long size, uint8_t* out, char* err, int errlen) {
  try {
    Jpeg j;
    j.d = data;
    j.n = (size_t)size;
    j.parse();
    const int W = j.width, H = j.height;
    std::vector<std::vector<uint8_t>> full(j.ncomp);
    for (int i = 0; i < j.ncomp; ++i) {
      Comp& c = j.comp[i];
      const int pw = c.aw * 8;
      std::vector<uint8_t> plane((size_t)pw * c.ah * 8);
      const uint16_t* q = j.qt[c.tq];
      const int bh = std::min(c.ah, (c.dh + 7) / 8 + 1), bw = std::min(c.aw, (c.dw + 7) / 8 + 1);
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx)
          idct_islow(j.block(c, by, bx), q, &plane[(size_t)by * 8 * pw + bx * 8], pw);
      full[i] = upsample(j, c, plane);
    }
    const size_t np = (size_t)W * H;
    if (j.ncomp == 1) {
      for (size_t p = 0; p < np; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
    } else {
      static const YccTables t;
      const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
      auto lim = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
      for (size_t p = 0; p < np; ++p) {
        const int y = Y[p], cb = Cb[p], cr = Cr[p];
        out[3 * p + 2] = lim(y + t.cr_r[cr]);
        out[3 * p + 1] = lim(y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        out[3 * p + 0] = lim(y + t.cb_b[cb]);
      }
    }
    return j.any_insufficient ? 1 : 0;
  } catch (const JpegError& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
    return -1;
  } catch (const std::exception& e) {
    std::snprintf(err, errlen, "JPEG decode failed: %s", e.what());
    return -1;
  } catch (...) {
    std::snprintf(err, errlen, "JPEG decode failed");
    return -1;
  }
}


// ---------------------------------------------------------------------------
// Drawing for utils/plots.py Annotator (cv2.rectangle / cv2.putText)
// ---------------------------------------------------------------------------
//
// What cv2 draws for the Annotator is reproduced from coverage masks recovered
// from cv2 itself (scripts/recover_annotator_atlas.py): the glyphs of font 0
// and one box per thickness. A mask is blended as cv2 blends text:
// round((dst * (255 - a) + color * a) / 255).

inline uint8_t blend(int d, int c, int a) { return (uint8_t)((d * (255 - a) + c * a + 127) / 255); }

// blend `mask` (mh, mw) into the BGR image (h, w, 3) with its top-left at (y0, x0), clipped
void blend_mask_u8(uint8_t* img, int h, int w, const uint8_t* mask, int mh, int mw, int y0, int x0,
                   const uint8_t* color) {
  for (int y = std::max(y0, 0); y < std::min(y0 + mh, h); ++y)
    for (int x = std::max(x0, 0); x < std::min(x0 + mw, w); ++x) {
      const int a = mask[(size_t)(y - y0) * mw + (x - x0)];
      if (!a) continue;
      uint8_t* p = img + ((size_t)y * w + x) * 3;
      for (int c = 0; c < 3; ++c) p[c] = blend(p[c], color[c], a);
    }
}

// A box with corners (x1, y1), (x2, y2) from the stamp of its thickness: the
// stamp (sh, sw) holds a box with corners at (m, m) and (3m, 3m); a pixel
// within m of a corner of the box reads the stamp at the same offset from the
// stamp's corner, a pixel farther along a side reads the middle of the side.
void draw_rect_stamp(uint8_t* img, int h, int w, const uint8_t* st, int sh, int sw, int m, int x1, int y1, int x2,
                     int y2, const uint8_t* color) {
  if (x1 > x2) std::swap(x1, x2);
  if (y1 > y2) std::swap(y1, y2);
  auto idx = [m](int v, int lo, int hi) {
    if (v - lo <= hi - v) return v - lo >= -m ? m + std::min(v - lo, m) : -1;
    return hi - v >= -m ? 3 * m - std::min(hi - v, m) : -1;
  };
  for (int y = std::max(y1 - m, 0); y <= std::min(y2 + m, h - 1); ++y) {
    const int sy = idx(y, y1, y2);
    if (sy < 0 || sy >= sh) continue;
    for (int x = std::max(x1 - m, 0); x <= std::min(x2 + m, w - 1); ++x) {
      const int sx = idx(x, x1, x2);
      if (sx < 0 || sx >= sw) continue;
      const int a = st[(size_t)sy * sw + sx];
      if (!a) continue;
      uint8_t* p = img + ((size_t)y * w + x) * 3;
      for (int c = 0; c < 3; ++c) p[c] = blend(p[c], color[c], a);
    }
  }
}

}  // extern "C"
