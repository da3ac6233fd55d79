// Native image pipeline of the port: JPEG decode + Pillow-exact bicubic
// resample + pad/crop/normalize, fused and threaded.
//
// A copy of fashionern_aaai2024_tpu/native/fastimage.cpp, kept in the
// port so that it builds from the port alone, with one addition: built
// with -DFE_NO_JPEG (native/image.py does so where g++ finds no
// <jpeglib.h>), the JPEG decoder is left out and every entry point that
// decodes returns kNoDecoder, while the resampler (fe_resize_bicubic_u8)
// stays native. fe_has_jpeg() says which build this is.
//
// Bit-exactness contract (held by tests/test_torch_data.py against the
// JAX package's library and PIL):
//   * decode: libjpeg-turbo islow IDCT, identical output to PIL's
//     bundled libjpeg-turbo for baseline/progressive gray/RGB JPEGs.
//   * resample: Pillow's Resample.c algorithm (PRECISION_BITS
//     fixed-point, clip8 rounding, horizontal-then-vertical, per-pass
//     u8 requantization) reproduced exactly, including the
//     skip-identity-pass rule.
// Unsupported inputs (CMYK/YCCK JPEGs, non-JPEG bytes, geometry that
// would need torchvision's crop padding) return a nonzero status; the
// Python caller then takes the PIL pipeline (the JAX route choice).

#include <stdio.h>

#ifndef FE_NO_JPEG
#include <jpeglib.h>
#include <setjmp.h>
#endif

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Threading (same shape as fastloader.cpp's helper; kept local so each
// translation unit builds into a self-contained .so).
// ---------------------------------------------------------------------------

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename Fn>
void parallel_for(int64_t total, int64_t grain, Fn fn) {
  int workers = hardware_threads();
  int64_t chunks = (total + grain - 1) / grain;
  if (chunks < 2 || workers < 2) {
    fn(static_cast<int64_t>(0), total);
    return;
  }
  if (chunks > workers) chunks = workers;
  int64_t per = (total + chunks - 1) / chunks;
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(chunks));
  for (int64_t c = 0; c < chunks; ++c) {
    int64_t first = c * per;
    int64_t last = first + per > total ? total : first + per;
    if (first >= last) break;
    threads.emplace_back([=] { fn(first, last); });
  }
  for (auto& t : threads) t.join();
}

#ifndef FE_NO_JPEG
// ---------------------------------------------------------------------------
// JPEG decode (system libjpeg-turbo, islow IDCT = PIL defaults)
// ---------------------------------------------------------------------------

struct JpegError {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_output_nothing(j_common_ptr) {}

#endif  // FE_NO_JPEG

constexpr int kOk = 0;
constexpr int kDecodeError = 1;
constexpr int kUnsupportedColor = 2;
constexpr int kGeometry = 3;
constexpr int kNoDecoder = 5;  // built with FE_NO_JPEG

// Upper bound on decoded pixels (≈256 MP): a hostile/corrupt header
// can advertise 65535×65535 (12.9 GB) — reject before allocating so
// the caller falls back to PIL instead of the process dying on OOM /
// bad_alloc. Real dataset images are < 1 MP.
constexpr int64_t kMaxPixels = int64_t{1} << 28;

// Decode to RGB u8 HWC. Grayscale JPEGs replicate to RGB inside
// libjpeg (identical to PIL's decode-L-then-convert-RGB ordering under
// the per-channel resampler). CMYK/YCCK are rejected: PIL's
// Adobe-inversion path is not worth replicating — callers fall back.
// (A JCS_EXT_RGBX 4-byte-pixel variant was built and measured ~10%
// slower — 33% more bytes through every stage; see BASELINE.md.)
#ifndef FE_NO_JPEG
int decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
               int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  jerr.pub.output_message = jpeg_output_nothing;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return kUnsupportedColor;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  if (static_cast<int64_t>(cinfo.output_width) * cinfo.output_height >
      kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}
#else
int decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
               int* w, int* h) {
  (void)buf, (void)len, (void)out, (void)w, (void)h;
  return kNoDecoder;
}
#endif  // FE_NO_JPEG

// ---------------------------------------------------------------------------
// Pillow-exact bicubic resampler (Resample.c, 8bpc path), with an
// output-window restriction so the CenterCrop never computes discarded
// pixels. Per-pixel math matches Pillow bit for bit: double-precision
// coefficient precompute, PRECISION_BITS fixed-point quantization,
// int32 accumulation, clip8 truncation between passes.
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // [winN][2] = xmin, xmax(count)
  std::vector<int32_t> kk;   // [winN][ksize] fixed-point taps
};

// Coefficients for output pixels [win0, win0+winN) of a full
// inSize→outSize bicubic resample (support 2.0, antialias when
// downscaling — Pillow's only mode).
Coeffs precompute_coeffs(int in_size, int out_size, int win0, int winN) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Coeffs c;
  c.ksize = ksize;
  c.bounds.resize(static_cast<size_t>(winN) * 2);
  c.kk.resize(static_cast<size_t>(winN) * ksize);
  std::vector<double> k(ksize);
  for (int i = 0; i < winN; ++i) {
    int xx = win0 + i;
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    int32_t* kq = &c.kk[static_cast<size_t>(i) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double v = k[x] * (1 << kPrecisionBits);
      kq[x] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
    for (int x = xmax; x < ksize; ++x) kq[x] = 0;
    c.bounds[static_cast<size_t>(i) * 2] = xmin;
    c.bounds[static_cast<size_t>(i) * 2 + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << (kPrecisionBits + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Horizontal pass: all rows, output columns restricted to the window.
void resample_horizontal(const uint8_t* in, int in_h, int in_w, int ch,
                         const Coeffs& c, int winN, uint8_t* out) {
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * ch;
    uint8_t* orow = out + static_cast<size_t>(y) * winN * ch;
    for (int i = 0; i < winN; ++i) {
      int xmin = c.bounds[static_cast<size_t>(i) * 2];
      int xmax = c.bounds[static_cast<size_t>(i) * 2 + 1];
      const int32_t* k = &c.kk[static_cast<size_t>(i) * c.ksize];
      for (int b = 0; b < ch; ++b) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x) {
          ss += row[static_cast<size_t>(x + xmin) * ch + b] * k[x];
        }
        orow[static_cast<size_t>(i) * ch + b] = clip8(ss);
      }
    }
  }
}

// Vertical pass: output rows restricted to the window, all columns of
// the (already horizontally resampled) input.
void resample_vertical(const uint8_t* in, int in_w, int ch, const Coeffs& c,
                       int winN, uint8_t* out) {
  for (int i = 0; i < winN; ++i) {
    int ymin = c.bounds[static_cast<size_t>(i) * 2];
    int ymax = c.bounds[static_cast<size_t>(i) * 2 + 1];
    const int32_t* k = &c.kk[static_cast<size_t>(i) * c.ksize];
    uint8_t* orow = out + static_cast<size_t>(i) * in_w * ch;
    for (int xb = 0; xb < in_w * ch; ++xb) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) {
        ss += in[static_cast<size_t>(y + ymin) * in_w * ch + xb] * k[y];
      }
      orow[xb] = clip8(ss);
    }
  }
}

// Full-image resample with an output crop window [cx0, cx0+cw) ×
// [cy0, cy0+ch_rows). Mirrors ImagingResample's pass structure,
// including skipping an identity pass (Pillow only runs a pass when
// the size changes along that axis).
int resample_window(const uint8_t* in, int in_h, int in_w, int ch,
                    int out_w, int out_h, int cx0, int cy0, int cw,
                    int ch_rows, std::vector<uint8_t>* out) {
  if (cx0 < 0 || cy0 < 0 || cx0 + cw > out_w || cy0 + ch_rows > out_h) {
    return kGeometry;
  }
  bool need_h = out_w != in_w;
  bool need_v = out_h != in_h;

  std::vector<uint8_t> mid;  // [in_h, cw, ch] after the horizontal pass
  const uint8_t* mid_ptr = nullptr;
  if (need_h) {
    Coeffs cx = precompute_coeffs(in_w, out_w, cx0, cw);
    mid.resize(static_cast<size_t>(in_h) * cw * ch);
    resample_horizontal(in, in_h, in_w, ch, cx, cw, mid.data());
    mid_ptr = mid.data();
  } else if (cx0 == 0 && cw == in_w) {
    mid_ptr = in;
  } else {
    // identity horizontal pass but a crop window: slice columns
    mid.resize(static_cast<size_t>(in_h) * cw * ch);
    for (int y = 0; y < in_h; ++y) {
      std::memcpy(mid.data() + static_cast<size_t>(y) * cw * ch,
                  in + (static_cast<size_t>(y) * in_w + cx0) * ch,
                  static_cast<size_t>(cw) * ch);
    }
    mid_ptr = mid.data();
  }

  out->resize(static_cast<size_t>(ch_rows) * cw * ch);
  if (need_v) {
    Coeffs cy = precompute_coeffs(in_h, out_h, cy0, ch_rows);
    resample_vertical(mid_ptr, cw, ch, cy, ch_rows, out->data());
  } else {
    std::memcpy(out->data(),
                mid_ptr + static_cast<size_t>(cy0) * cw * ch,
                static_cast<size_t>(ch_rows) * cw * ch);
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// Reference preprocessing geometry (data/transforms.py semantics,
// themselves pinned to `dataloader/dataset.py:9-87`). All the Python
// rounding quirks matter: int() truncation in the pad amounts,
// banker's rounding (llrint) in the resize/crop arithmetic.
// ---------------------------------------------------------------------------

constexpr int kPadNone = 0;
constexpr int kPadTarget = 1;
constexpr int kPadSquare = 2;

int preprocess_rgb(const std::vector<uint8_t>& rgb, int w, int h, int ch,
                   int dim, int pad_mode, double target_ratio,
                   std::vector<uint8_t>* out) {
  // 1. pad (TargetPad / SquarePad)
  int hp = 0, vp = 0;
  if (pad_mode == kPadSquare) {
    int m = std::max(w, h);
    hp = (m - w) / 2;
    vp = (m - h) / 2;
  } else if (pad_mode == kPadTarget) {
    double actual =
        static_cast<double>(std::max(w, h)) / static_cast<double>(std::min(w, h));
    if (!(actual < target_ratio)) {
      double scaled = static_cast<double>(std::max(w, h)) / target_ratio;
      hp = std::max(static_cast<int>((scaled - w) / 2.0), 0);
      vp = std::max(static_cast<int>((scaled - h) / 2.0), 0);
    }
  } else if (pad_mode != kPadNone) {
    return kGeometry;
  }
  const uint8_t* src = rgb.data();
  std::vector<uint8_t> padded;
  int pw = w + 2 * hp, ph = h + 2 * vp;
  if (hp != 0 || vp != 0) {
    padded.assign(static_cast<size_t>(pw) * ph * ch, 0);
    for (int y = 0; y < h; ++y) {
      std::memcpy(
          padded.data() + ((static_cast<size_t>(y + vp) * pw) + hp) * ch,
          rgb.data() + static_cast<size_t>(y) * w * ch,
          static_cast<size_t>(w) * ch);
    }
    src = padded.data();
  }

  // 2. shorter-side resize target dims (torchvision Resize(dim))
  int64_t nw, nh;
  if (pw <= ph) {
    nw = dim;
    nh = std::max<int64_t>(
        1, llrint(static_cast<double>(static_cast<int64_t>(ph) * dim) / pw));
  } else {
    nh = dim;
    nw = std::max<int64_t>(
        1, llrint(static_cast<double>(static_cast<int64_t>(pw) * dim) / ph));
  }
  if (nw < dim || nh < dim || nw > (1 << 24) || nh > (1 << 24)) {
    return kGeometry;  // crop would need padding → PIL fallback
  }

  // 3. center-crop offsets (torchvision CenterCrop(dim))
  int left = static_cast<int>(rint((nw - dim) / 2.0));
  int top = static_cast<int>(rint((nh - dim) / 2.0));

  // 4. fused resample+crop
  return resample_window(src, ph, pw, ch, static_cast<int>(nw),
                         static_cast<int>(nh), left, top, dim, dim, out);
}

int decode_preprocess_impl(const uint8_t* buf, int64_t len, int dim,
                           int pad_mode, double target_ratio,
                           const float* mean, const float* stdd,
                           int normalize, void* out_v) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  int rc = decode_rgb(buf, static_cast<size_t>(len), &rgb, &w, &h);
  if (rc != kOk) return rc;
  std::vector<uint8_t> crop;
  rc = preprocess_rgb(rgb, w, h, 3, dim, pad_mode, target_ratio, &crop);
  if (rc != kOk) return rc;
  size_t n = crop.size();
  if (!normalize) {
    std::memcpy(out_v, crop.data(), n);
    return kOk;
  }
  // Per-channel u8→f32 LUTs: 3 KB, L1-resident, exact same float math
  // as (x/255 - mean)/std evaluated per byte value.
  float lut[3][256];
  for (int c = 0; c < 3; ++c) {
    float scale = 1.0f / (255.0f * stdd[c]);
    float shift = -mean[c] / stdd[c];
    for (int v = 0; v < 256; ++v) {
      lut[c][v] = static_cast<float>(v) * scale + shift;
    }
  }
  float* out = static_cast<float*>(out_v);
  for (size_t i = 0; i < n; i += 3) {
    out[i] = lut[0][crop[i]];
    out[i + 1] = lut[1][crop[i + 1]];
    out[i + 2] = lut[2][crop[i + 2]];
  }
  return kOk;
}

// 13-crop patch extraction (tools/extract_patches.py geometry,
// itself pinned to the reference's extract_patch_features_200k.py):
// decode → full bicubic resize to RESIZE² → 2×2 + 3×3 integer-grid
// crops → per-crop bicubic to dim² → CLIP-normalize. The crops are
// square, so the TargetPad step of the per-crop preprocess is a no-op
// (ratio 1.0 < 1.25) and the shorter-side resize is exactly dim².
// Everything reuses the Pillow-exact resampler, so output is
// bit-identical to the PIL path.
int extract_crops_impl(const uint8_t* buf, int64_t len, int resize,
                       int dim, const float* mean, const float* stdd,
                       float* out /* [13, dim, dim, 3] */) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  int rc = decode_rgb(buf, static_cast<size_t>(len), &rgb, &w, &h);
  if (rc != kOk) return rc;
  std::vector<uint8_t> sq;  // RESIZE² board
  rc = resample_window(rgb.data(), h, w, 3, resize, resize, 0, 0, resize,
                       resize, &sq);
  if (rc != kOk) return rc;

  float lut[3][256];
  for (int c = 0; c < 3; ++c) {
    float scale = 1.0f / (255.0f * stdd[c]);
    float shift = -mean[c] / stdd[c];
    for (int v = 0; v < 256; ++v) {
      lut[c][v] = static_cast<float>(v) * scale + shift;
    }
  }

  int slot = 0;
  std::vector<uint8_t> crop, small;
  for (int g : {2, 3}) {
    int iw = resize / g, ih = resize / g;  // int(w/g): exact for 360
    for (int i = 0; i < g; ++i) {
      for (int j = 0; j < g; ++j) {
        crop.resize(static_cast<size_t>(iw) * ih * 3);
        for (int y = 0; y < ih; ++y) {
          std::memcpy(crop.data() + static_cast<size_t>(y) * iw * 3,
                      sq.data() +
                          ((static_cast<size_t>(i * ih + y) * resize) +
                           static_cast<size_t>(j) * iw) * 3,
                      static_cast<size_t>(iw) * 3);
        }
        rc = resample_window(crop.data(), ih, iw, 3, dim, dim, 0, 0, dim,
                             dim, &small);
        if (rc != kOk) return rc;
        float* o = out + static_cast<size_t>(slot) * dim * dim * 3;
        for (size_t p = 0; p < small.size(); p += 3) {
          o[p] = lut[0][small[p]];
          o[p + 1] = lut[1][small[p + 1]];
          o[p + 2] = lut[2][small[p + 2]];
        }
        ++slot;
      }
    }
  }
  return kOk;
}

// No C++ exception may cross the extern "C" / ctypes boundary (or a
// std::thread lambda in the batch path, where it would std::terminate
// the process) — allocation failure degrades to the PIL fallback.
int decode_preprocess_one(const uint8_t* buf, int64_t len, int dim,
                          int pad_mode, double target_ratio, const float* mean,
                          const float* stdd, int normalize,
                          void* out_v) noexcept {
  try {
    return decode_preprocess_impl(buf, len, dim, pad_mode, target_ratio, mean,
                                  stdd, normalize, out_v);
  } catch (...) {
    return kDecodeError;
  }
}

}  // namespace

extern "C" {

// 1 when the JPEG decoder is built in, 0 under FE_NO_JPEG.
int fe_has_jpeg() {
#ifdef FE_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

// JPEG dims without decoding (header parse only).
int fe_jpeg_dims(const uint8_t* buf, int64_t len, int* w, int* h) {
#ifdef FE_NO_JPEG
  (void)buf, (void)len, (void)w, (void)h;
  return kNoDecoder;
#else
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  jerr.pub.output_message = jpeg_output_nothing;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return kUnsupportedColor;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
#endif  // FE_NO_JPEG
}

// JPEG → RGB u8 HWC into a caller buffer of cap ≥ w*h*3 bytes (use
// fe_jpeg_dims first). Returns a status code (0 ok / 1 decode error /
// 2 unsupported colorspace / 4 cap too small).
int fe_decode_jpeg(const uint8_t* buf, int64_t len, uint8_t* out, int64_t cap,
                   int* w, int* h) {
  try {
    std::vector<uint8_t> rgb;
    int rc = decode_rgb(buf, static_cast<size_t>(len), &rgb, w, h);
    if (rc != kOk) return rc;
    if (static_cast<int64_t>(rgb.size()) > cap) return 4;
    std::memcpy(out, rgb.data(), rgb.size());
    return kOk;
  } catch (...) {
    return kDecodeError;
  }
}

// Pillow-exact full-image bicubic resize of u8 HWC (any channel count).
// out must hold out_h*out_w*ch bytes.
int fe_resize_bicubic_u8(const uint8_t* src, int in_h, int in_w, int ch,
                         int out_w, int out_h, uint8_t* out) {
  try {
    std::vector<uint8_t> res;
    int rc = resample_window(src, in_h, in_w, ch, out_w, out_h, 0, 0, out_w,
                             out_h, &res);
    if (rc != kOk) return rc;
    std::memcpy(out, res.data(), res.size());
    return kOk;
  } catch (...) {
    return kDecodeError;
  }
}

// Full single-image pipeline: decode → pad → resize → crop →
// (optional) CLIP-normalize. out is [dim, dim, 3] float32 when
// normalize, else u8.
int fe_decode_preprocess(const uint8_t* buf, int64_t len, int dim,
                         int pad_mode, double target_ratio, const float* mean,
                         const float* stdd, int normalize, void* out) {
  return decode_preprocess_one(buf, len, dim, pad_mode, target_ratio, mean,
                               stdd, normalize, out);
}

// One image → [13, dim, dim, 3] CLIP-normalized crops (2×2 + 3×3 grid
// of the resize² board — the reference's offline patch-extraction
// geometry). Returns a status code; nonzero → caller falls back.
int fe_extract_crops(const uint8_t* buf, int64_t len, int resize, int dim,
                     const float* mean, const float* stdd, float* out) {
  try {
    return extract_crops_impl(buf, len, resize, dim, mean, stdd, out);
  } catch (...) {
    return kDecodeError;
  }
}


// Threaded batch: bufs/lens are n parallel arrays; out is one
// contiguous [n, dim, dim, 3] block; statuses[i] gets the per-item
// code (items with nonzero status leave their slot zero-filled for the
// caller's PIL fallback to overwrite).
void fe_decode_preprocess_batch(const uint8_t* const* bufs,
                                const int64_t* lens, int64_t n, int dim,
                                int pad_mode, double target_ratio,
                                const float* mean, const float* stdd,
                                int normalize, void* out, int64_t* statuses) {
  size_t item_bytes = static_cast<size_t>(dim) * dim * 3 *
                      (normalize ? sizeof(float) : sizeof(uint8_t));
  parallel_for(n, /*grain=*/1, [&](int64_t first, int64_t last) {
    for (int64_t i = first; i < last; ++i) {
      void* slot = static_cast<char*>(out) + static_cast<size_t>(i) * item_bytes;
      int rc = decode_preprocess_one(bufs[i], lens[i], dim, pad_mode,
                                     target_ratio, mean, stdd, normalize, slot);
      if (rc != kOk) std::memset(slot, 0, item_bytes);
      statuses[i] = rc;
    }
  });
}

}  // extern "C"
