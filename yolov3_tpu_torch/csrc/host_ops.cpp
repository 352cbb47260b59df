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
#include <cstring>
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

}  // extern "C"
