// Native host-side augmentation kernel: fused affine resample.
//
// The reference's CPU transform pipeline (dataloaders/transforms.py in
// dontLoveBugs/CSPN_monodepth, SURVEY.md R10) chains rotate -> resize ->
// crop -> hflip -> jitter as separate full-image passes.  Rotation, scale,
// crop and flip are all affine maps, so this kernel composes them into ONE
// inverse-affine gather per output pixel: for output (y, x) the source
// coordinate is
//
//     ys = c[0] + c[1]*y + c[2]*x
//     xs = c[3] + c[4]*y + c[5]*x
//
// with out-of-bounds source coordinates producing 0 (= invalid depth /
// black border, matching the reference's rotation fill).  RGB samples
// bilinearly; depth samples nearest (so invalid zeros never bleed into
// valid depths).  Per-channel gain (color jitter, and the uint8->[0,1]
// normalization folded in) and the depth /= s scale are applied in the
// same pass.
//
// Called from Python worker threads via ctypes: the call releases the GIL,
// so the data pipeline scales across host cores, where the numpy executor
// (data/transforms.py:affine_resample) holds the interpreter lock for much
// of its work.
//
// The port's own copy of cspn_monodepth_tpu/native/augment.cpp (the same
// functions and arithmetic; the port imports nothing of the JAX package).
// Build: g++ -O3 -shared -fPIC (see native/__init__.py); no dependencies.

#include <cmath>
#include <cstdint>

namespace {

inline long iclip(long v, long lo, long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline float fclip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// Bilinear affine resample for a (h, w, ch) float32 image.
// gain: per-channel multiplier applied after sampling (length ch);
// results are clipped to [clip_lo, clip_hi] when clip_hi > clip_lo.
void affine_bilinear_f32(const float* src, long h, long w, long ch,
                         const float* coef, float* dst, long oh, long ow,
                         const float* gain, float clip_lo, float clip_hi) {
  const float c0 = coef[0], cy = coef[1], cx = coef[2];
  const float d0 = coef[3], dy = coef[4], dx = coef[5];
  const bool do_clip = clip_hi > clip_lo;
  for (long y = 0; y < oh; ++y) {
    // per-pixel evaluation (base + cx*x), bitwise-matching the numpy
    // reference (no incremental-accumulation drift on nearest ties)
    const float ybase = c0 + cy * (float)y;
    const float xbase = d0 + dy * (float)y;
    float* out_row = dst + y * ow * ch;
    for (long x = 0; x < ow; ++x) {
      const float ys = ybase + cx * (float)x;
      const float xs = xbase + dx * (float)x;
      float* out = out_row + x * ch;
      const bool inside =
          ys >= 0.f && ys <= (float)(h - 1) && xs >= 0.f && xs <= (float)(w - 1);
      if (!inside) {
        for (long c = 0; c < ch; ++c) out[c] = 0.f;
        continue;
      }
      const long y0 = iclip((long)std::floor(ys), 0, h - 1);
      const long x0 = iclip((long)std::floor(xs), 0, w - 1);
      const long y1 = y0 + 1 < h ? y0 + 1 : h - 1;
      const long x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const float wy = fclip(ys - (float)y0, 0.f, 1.f);
      const float wx = fclip(xs - (float)x0, 0.f, 1.f);
      const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
      const float w10 = wy * (1.f - wx), w11 = wy * wx;
      const float* p00 = src + (y0 * w + x0) * ch;
      const float* p01 = src + (y0 * w + x1) * ch;
      const float* p10 = src + (y1 * w + x0) * ch;
      const float* p11 = src + (y1 * w + x1) * ch;
      for (long c = 0; c < ch; ++c) {
        float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        v *= gain[c];
        out[c] = do_clip ? fclip(v, clip_lo, clip_hi) : v;
      }
    }
  }
}

// Nearest-neighbor affine resample for a (h, w) float32 plane (depth).
// scale multiplies sampled values (the reference's depth /= s under
// scale augmentation).  rint = round-half-even, matching numpy.
void affine_nearest_f32(const float* src, long h, long w, const float* coef,
                        float* dst, long oh, long ow, float scale) {
  const float c0 = coef[0], cy = coef[1], cx = coef[2];
  const float d0 = coef[3], dy = coef[4], dx = coef[5];
  for (long y = 0; y < oh; ++y) {
    const float ybase = c0 + cy * (float)y;
    const float xbase = d0 + dy * (float)y;
    float* out_row = dst + y * ow;
    for (long x = 0; x < ow; ++x) {
      const float ys = ybase + cx * (float)x;
      const float xs = xbase + dx * (float)x;
      const bool inside =
          ys >= 0.f && ys <= (float)(h - 1) && xs >= 0.f && xs <= (float)(w - 1);
      if (!inside) {
        out_row[x] = 0.f;
        continue;
      }
      const long yi = iclip((long)std::rint(ys), 0, h - 1);
      const long xi = iclip((long)std::rint(xs), 0, w - 1);
      out_row[x] = src[yi * w + xi] * scale;
    }
  }
}

// uint8 (h, w, ch) source variant: skips the numpy astype(float32) copy of
// the full-resolution input; the uint8->[0,1] normalization is folded into
// gain by the caller.
void affine_bilinear_u8(const uint8_t* src, long h, long w, long ch,
                        const float* coef, float* dst, long oh, long ow,
                        const float* gain, float clip_lo, float clip_hi) {
  const float c0 = coef[0], cy = coef[1], cx = coef[2];
  const float d0 = coef[3], dy = coef[4], dx = coef[5];
  const bool do_clip = clip_hi > clip_lo;
  for (long y = 0; y < oh; ++y) {
    // per-pixel evaluation (base + cx*x), bitwise-matching the numpy
    // reference (no incremental-accumulation drift on nearest ties)
    const float ybase = c0 + cy * (float)y;
    const float xbase = d0 + dy * (float)y;
    float* out_row = dst + y * ow * ch;
    for (long x = 0; x < ow; ++x) {
      const float ys = ybase + cx * (float)x;
      const float xs = xbase + dx * (float)x;
      float* out = out_row + x * ch;
      const bool inside =
          ys >= 0.f && ys <= (float)(h - 1) && xs >= 0.f && xs <= (float)(w - 1);
      if (!inside) {
        for (long c = 0; c < ch; ++c) out[c] = 0.f;
        continue;
      }
      const long y0 = iclip((long)std::floor(ys), 0, h - 1);
      const long x0 = iclip((long)std::floor(xs), 0, w - 1);
      const long y1 = y0 + 1 < h ? y0 + 1 : h - 1;
      const long x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const float wy = fclip(ys - (float)y0, 0.f, 1.f);
      const float wx = fclip(xs - (float)x0, 0.f, 1.f);
      const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
      const float w10 = wy * (1.f - wx), w11 = wy * wx;
      const uint8_t* p00 = src + (y0 * w + x0) * ch;
      const uint8_t* p01 = src + (y0 * w + x1) * ch;
      const uint8_t* p10 = src + (y1 * w + x0) * ch;
      const uint8_t* p11 = src + (y1 * w + x1) * ch;
      for (long c = 0; c < ch; ++c) {
        float v = w00 * (float)p00[c] + w01 * (float)p01[c] +
                  w10 * (float)p10[c] + w11 * (float)p11[c];
        v *= gain[c];
        out[c] = do_clip ? fclip(v, clip_lo, clip_hi) : v;
      }
    }
  }
}

}  // extern "C"
