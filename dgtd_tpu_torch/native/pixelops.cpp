// Host pixel pipeline of the port's folder datasets: a fused half-pixel
// bilinear resize, normalize and horizontal flip of a decoded uint8 HWC
// image, in one pass over the pixels (uint8 in, float32 or uint8 out).
//
// The port's own copy of the JAX package's dgtd_tpu/native/pixelops.cpp,
// the same arithmetic, so that both give the same pixels bit for bit when
// built with the same compiler and flags. Host code, not a kernel of the
// card.
//
// Resize semantics: half-pixel bilinear with edge clamping, as torch
// F.interpolate(align_corners=False). Built at first use by
// dgtd_tpu_torch/native/pixelops.py (g++ -O3 -shared -fPIC) and bound with
// ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tap {
  int i0;
  int i1;
  float w1;  // weight of i1; i0 gets (1 - w1)
};

static void build_taps(int src, int dst, std::vector<Tap>& taps) {
  taps.resize(dst);
  const float scale = static_cast<float>(src) / static_cast<float>(dst);
  for (int d = 0; d < dst; ++d) {
    float s = (d + 0.5f) * scale - 0.5f;
    if (s < 0.f) s = 0.f;
    int i0 = static_cast<int>(s);
    if (i0 > src - 1) i0 = src - 1;
    int i1 = i0 + 1 < src ? i0 + 1 : src - 1;
    taps[d] = {i0, i1, s - static_cast<float>(i0)};
  }
}

}  // namespace

extern "C" {

// src: uint8 HWC (sh, sw, c); dst: float32 HWC (dh, dw, c).
// mean/stddev: per-channel (c) applied as (x/255 - mean) / stddev; pass
// mean=0, stddev=1 for label/depth planes. flip != 0 mirrors horizontally
// (applied on the source index so it fuses with the resize).
void resize_bilinear_normalize(const uint8_t* src, int sh, int sw, int c,
                               float* dst, int dh, int dw, const float* mean,
                               const float* stddev, int flip) {
  std::vector<Tap> ytaps, xtaps;
  build_taps(sh, dh, ytaps);
  build_taps(sw, dw, xtaps);
  std::vector<float> inv_std(c), off(c);
  for (int ch = 0; ch < c; ++ch) {
    inv_std[ch] = 1.0f / (255.0f * stddev[ch]);
    off[ch] = mean[ch] / stddev[ch];
  }
  // row-interpolated scratch: (sw, c) for the two source rows blended
  std::vector<float> rowbuf(static_cast<size_t>(sw) * c);
  int last_y0 = -1, last_y1 = -1;
  float last_wy = -1.f;
  for (int y = 0; y < dh; ++y) {
    const Tap ty = ytaps[y];
    if (ty.i0 != last_y0 || ty.i1 != last_y1 || ty.w1 != last_wy) {
      const uint8_t* r0 = src + static_cast<size_t>(ty.i0) * sw * c;
      const uint8_t* r1 = src + static_cast<size_t>(ty.i1) * sw * c;
      const float w1 = ty.w1, w0 = 1.0f - ty.w1;
      for (size_t i = 0; i < static_cast<size_t>(sw) * c; ++i) {
        rowbuf[i] = w0 * r0[i] + w1 * r1[i];
      }
      last_y0 = ty.i0;
      last_y1 = ty.i1;
      last_wy = ty.w1;
    }
    float* out_row = dst + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      // fused resize(flip(src)): taps at x, source columns mirrored
      const Tap tx = xtaps[x];
      int x0 = tx.i0, x1 = tx.i1;
      const float wx1 = tx.w1;
      if (flip) {
        x0 = sw - 1 - tx.i0;
        x1 = sw - 1 - tx.i1;
      }
      const float* p0 = rowbuf.data() + static_cast<size_t>(x0) * c;
      const float* p1 = rowbuf.data() + static_cast<size_t>(x1) * c;
      float* o = out_row + static_cast<size_t>(x) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float v = (1.0f - wx1) * p0[ch] + wx1 * p1[ch];
        o[ch] = v * inv_std[ch] - off[ch];
      }
    }
  }
}

// uint8-out variant for device-side normalization: same half-pixel bilinear
// resize (+ optional flip) but the output stays uint8 (round-to-nearest).
// Shipping uint8 to the device and normalizing there cuts host->device
// transfer 4x; the model's step applies (x/255 - mean)/std on the device.
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw, int flip) {
  std::vector<Tap> ytaps, xtaps;
  build_taps(sh, dh, ytaps);
  build_taps(sw, dw, xtaps);
  std::vector<float> rowbuf(static_cast<size_t>(sw) * c);
  int last_y0 = -1, last_y1 = -1;
  float last_wy = -1.f;
  for (int y = 0; y < dh; ++y) {
    const Tap ty = ytaps[y];
    if (ty.i0 != last_y0 || ty.i1 != last_y1 || ty.w1 != last_wy) {
      const uint8_t* r0 = src + static_cast<size_t>(ty.i0) * sw * c;
      const uint8_t* r1 = src + static_cast<size_t>(ty.i1) * sw * c;
      const float w1 = ty.w1, w0 = 1.0f - ty.w1;
      for (size_t i = 0; i < static_cast<size_t>(sw) * c; ++i) {
        rowbuf[i] = w0 * r0[i] + w1 * r1[i];
      }
      last_y0 = ty.i0;
      last_y1 = ty.i1;
      last_wy = ty.w1;
    }
    uint8_t* out_row = dst + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      const Tap tx = xtaps[x];
      int x0 = tx.i0, x1 = tx.i1;
      const float wx1 = tx.w1;
      if (flip) {
        x0 = sw - 1 - tx.i0;
        x1 = sw - 1 - tx.i1;
      }
      const float* p0 = rowbuf.data() + static_cast<size_t>(x0) * c;
      const float* p1 = rowbuf.data() + static_cast<size_t>(x1) * c;
      uint8_t* o = out_row + static_cast<size_t>(x) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float v = (1.0f - wx1) * p0[ch] + wx1 * p1[ch];
        int q = static_cast<int>(v + 0.5f);
        if (q < 0) q = 0;
        if (q > 255) q = 255;
        o[ch] = static_cast<uint8_t>(q);
      }
    }
  }
}

}  // extern "C"
