// fastdata: native decode + resize for the segmentation data path (the
// port's copy of the JAX package's data/_native/fastdata.cpp, unchanged
// below this comment).
//
// PNG/JPEG decode, PIL-compatible resize (triangle-filter bilinear for
// images, center-convention nearest for labels) and the 256^3 RGB->trainId
// LUT mapping (reference preprocess_gta5_labels.py:12-25) in one C call per
// sample, releasing the GIL for the whole decode+resize so the Python-side
// thread pool scales across cores. A host decode: nothing here runs on the
// device.
//
// Compatibility contract (tested in tests/test_torch_native_data.py):
//   - decode matches PIL exactly (both wrap libpng/libjpeg);
//   - bilinear resize matches PIL's BILINEAR (PIL's 8-bit fixed-point
//     two-pass resampler, replicated);
//   - nearest matches PIL's NEAREST exactly (src = floor((i + 0.5)*scale));
//   - RGB label LUT mapping matches data/labels.py exactly.
//
// Build (done automatically by data/native.py):
//   g++ -O3 -shared -fPIC -std=c++17 fastdata.cpp -o libfastdata.so -lpng -ljpeg -pthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <cmath>
#include <csetjmp>
#include <cstring>
#include <vector>

#define FD_OK 0
#define FD_ERR_OPEN -1
#define FD_ERR_FORMAT -2
#define FD_ERR_DECODE -3
#define FD_ERR_UNSUPPORTED -4
#define FD_ERR_RGB_LABEL_NEEDS_LUT -5

namespace {

struct Decoded {
  std::vector<unsigned char> data;  // h * w * c
  int h = 0, w = 0, c = 0;
};

// ---------------------------------------------------------------- PNG ----

struct PngErr {
  jmp_buf jb;
};

void png_on_error(png_structp png, png_const_charp) {
  longjmp(static_cast<PngErr*>(png_get_error_ptr(png))->jb, 1);
}
void png_on_warn(png_structp, png_const_charp) {}

// want_rgb: expand gray/palette to RGB (image path). Otherwise keep one
// channel for gray and palette (raw indices, like numpy on a PIL "P"/"L"
// image) and RGB(A) as 3 channels.
int decode_png(FILE* f, Decoded& out, bool want_rgb) {
  PngErr err;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, &err,
                                           png_on_error, png_on_warn);
  if (!png) return FD_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return FD_ERR_DECODE;
  }
  // Constructed BEFORE setjmp: a longjmp from inside png_read_image must
  // not jump over a live object's construction point (UB + leak); with the
  // declaration here, the error path returns through this frame and the
  // destructor runs normally.
  std::vector<png_bytep> rows;
  if (setjmp(err.jb)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return FD_ERR_DECODE;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  bool palette = color == PNG_COLOR_TYPE_PALETTE;
  bool gray = color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA;
  if (depth == 16) {
    if (!want_rgb) {
      // 16-bit label values don't fit u8; PIL reads them verbatim
      // (mode I;16) — refuse so the caller falls back to the PIL path.
      png_destroy_read_struct(&png, &info, nullptr);
      return FD_ERR_UNSUPPORTED;
    }
    png_set_strip_16(png);
  }
  if (depth < 8) {
    // bit-replicated expansion to 8-bit for gray (PIL scales 1-bit to
    // 0/255); plain unpacking for palette (indices must stay raw)
    if (gray)
      png_set_expand_gray_1_2_4_to_8(png);
    else
      png_set_packing(png);
  }
  if (palette && want_rgb) png_set_palette_to_rgb(png);
  if (gray && want_rgb) png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS) && want_rgb && palette)
    png_set_strip_alpha(png);  // after palette_to_rgb expansion

  png_read_update_info(png, info);
  out.h = static_cast<int>(png_get_image_height(png, info));
  out.w = static_cast<int>(png_get_image_width(png, info));
  out.c = static_cast<int>(png_get_channels(png, info));
  if (out.c != 1 && out.c != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return FD_ERR_UNSUPPORTED;
  }
  // Corrupt headers can declare absurd dimensions; cap the decode buffer
  // (2^31 bytes) so a hostile/truncated file fails cleanly instead of
  // throwing bad_alloc through the C ABI.
  if (out.h <= 0 || out.w <= 0 ||
      static_cast<long long>(out.h) * out.w * out.c >= (1LL << 31)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return FD_ERR_DECODE;
  }
  out.data.resize(static_cast<size_t>(out.h) * out.w * out.c);
  rows.resize(out.h);
  for (int y = 0; y < out.h; ++y)
    rows[y] = out.data.data() + static_cast<size_t>(y) * out.w * out.c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return FD_OK;
}

// --------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_on_error(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

int decode_jpeg(FILE* f, Decoded& out) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_on_error;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return FD_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out.h = static_cast<int>(cinfo.output_height);
  out.w = static_cast<int>(cinfo.output_width);
  out.c = 3;
  if (out.h <= 0 || out.w <= 0 ||
      static_cast<long long>(out.h) * out.w * 3 >= (1LL << 31)) {
    jpeg_destroy_decompress(&cinfo);
    return FD_ERR_DECODE;
  }
  out.data.resize(static_cast<size_t>(out.h) * out.w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out.data.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return FD_OK;
}

int decode_file(const char* path, Decoded& out, bool want_rgb) {
  FILE* f = fopen(path, "rb");
  if (!f) return FD_ERR_OPEN;
  unsigned char magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return FD_ERR_FORMAT;
  }
  rewind(f);
  int rc;
  if (magic[0] == 0x89 && magic[1] == 'P')
    rc = decode_png(f, out, want_rgb);
  else if (magic[0] == 0xFF && magic[1] == 0xD8)
    rc = decode_jpeg(f, out);
  else
    rc = FD_ERR_FORMAT;
  fclose(f);
  return rc;
}

// -------------------------------------------------------------- resize ----

// PIL-compatible triangle-filter resampling table for one axis, in PIL's
// 8-bit-pixel fixed-point scheme (Pillow src/libImaging/Resample.c:
// precompute_coeffs + normalize_coeffs_8bpc, bilinear support = 1,
// PRECISION_BITS = 32 - 8 - 2). Bit-exact with Image.resize(BILINEAR).
constexpr int kPrecisionBits = 32 - 8 - 2;

struct Axis {
  std::vector<int> lo, n;  // per-output window [lo, lo+n)
  std::vector<int> w;      // fixed-point weights, flattened, stride kmax
  int kmax = 0;
};

Axis build_axis(int in_n, int out_n) {
  Axis ax;
  double scale = static_cast<double>(in_n) / out_n;
  double fscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * fscale;  // bilinear filter support
  ax.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  ax.lo.resize(out_n);
  ax.n.resize(out_n);
  ax.w.assign(static_cast<size_t>(out_n) * ax.kmax, 0);
  std::vector<double> ww(ax.kmax);
  for (int xx = 0; xx < out_n; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_n) xmax = in_n;
    double sum = 0.0;
    for (int j = xmin; j < xmax; ++j) {
      double t = 1.0 - std::fabs((j + 0.5 - center) / fscale);
      if (t < 0) t = 0;
      ww[j - xmin] = t;
      sum += t;
    }
    int* k = ax.w.data() + static_cast<size_t>(xx) * ax.kmax;
    for (int j = 0; j < xmax - xmin; ++j) {
      double v = (ww[j] / sum) * (1 << kPrecisionBits);
      k[j] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
    }
    ax.lo[xx] = xmin;
    ax.n[xx] = xmax - xmin;
  }
  return ax;
}

inline unsigned char clip8(int ss) {
  int v = ss >> kPrecisionBits;
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<unsigned char>(v));
}

void resize_bilinear_u8(const unsigned char* src, int ih, int iw, int c,
                        unsigned char* dst, int oh, int ow) {
  Axis hx = build_axis(iw, ow);
  Axis vx = build_axis(ih, oh);
  // horizontal pass into a u8 intermediate — PIL's two-pass structure,
  // same rounding at each stage, so results stay bit-exact with PIL
  std::vector<unsigned char> tmp(static_cast<size_t>(ih) * ow * c);
  constexpr int half = 1 << (kPrecisionBits - 1);
  for (int y = 0; y < ih; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * iw * c;
    unsigned char* trow = tmp.data() + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const int* w = hx.w.data() + static_cast<size_t>(x) * hx.kmax;
      const unsigned char* win = row + static_cast<size_t>(hx.lo[x]) * c;
      for (int ch = 0; ch < c; ++ch) {
        int acc = half;
        for (int k = 0; k < hx.n[x]; ++k) acc += w[k] * win[k * c + ch];
        trow[x * c + ch] = clip8(acc);
      }
    }
  }
  // vertical pass
  for (int y = 0; y < oh; ++y) {
    const int* w = vx.w.data() + static_cast<size_t>(y) * vx.kmax;
    unsigned char* orow = dst + static_cast<size_t>(y) * ow * c;
    const unsigned char* tbase =
        tmp.data() + static_cast<size_t>(vx.lo[y]) * ow * c;
    const size_t stride = static_cast<size_t>(ow) * c;
    for (size_t i = 0; i < stride; ++i) {
      int acc = half;
      for (int k = 0; k < vx.n[y]; ++k) acc += w[k] * tbase[k * stride + i];
      orow[i] = clip8(acc);
    }
  }
}

// PIL NEAREST: src index = floor((i + 0.5) * in/out).
void resize_nearest_u8(const unsigned char* src, int ih, int iw, int c,
                       unsigned char* dst, int oh, int ow) {
  std::vector<int> sx(ow), sy(oh);
  for (int x = 0; x < ow; ++x) {
    int v = static_cast<int>((x + 0.5) * iw / ow);
    sx[x] = v >= iw ? iw - 1 : v;
  }
  for (int y = 0; y < oh; ++y) {
    int v = static_cast<int>((y + 0.5) * ih / oh);
    sy[y] = v >= ih ? ih - 1 : v;
  }
  for (int y = 0; y < oh; ++y) {
    const unsigned char* row = src + static_cast<size_t>(sy[y]) * iw * c;
    unsigned char* orow = dst + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x)
      for (int ch = 0; ch < c; ++ch) orow[x * c + ch] = row[sx[x] * c + ch];
  }
}

}  // namespace

extern "C" {

int fd_version() { return 1; }

const char* fd_error_name(int code) {
  switch (code) {
    case FD_OK: return "ok";
    case FD_ERR_OPEN: return "cannot open file";
    case FD_ERR_FORMAT: return "not a PNG or JPEG";
    case FD_ERR_DECODE: return "decode failed";
    case FD_ERR_UNSUPPORTED: return "unsupported channel count";
    case FD_ERR_RGB_LABEL_NEEDS_LUT: return "RGB label requires a LUT";
    default: return "unknown error";
  }
}

// Decode an image file to RGB u8 and bilinear-resize into out (out_h*out_w*3).
// No exception may cross the C ABI (std::terminate): decode/resize bodies
// run under try/catch and report FD_ERR_DECODE so the Python caller can
// fall back to the PIL path.
int fd_load_image(const char* path, unsigned char* out, int out_h,
                  int out_w) try {
  Decoded d;
  int rc = decode_file(path, d, /*want_rgb=*/true);
  if (rc != FD_OK) return rc;
  if (d.c == 1) {  // grayscale JPEG path cannot happen (JCS_RGB); PNG can
    std::vector<unsigned char> rgb(static_cast<size_t>(d.h) * d.w * 3);
    for (size_t i = 0; i < static_cast<size_t>(d.h) * d.w; ++i)
      rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = d.data[i];
    d.data.swap(rgb);
    d.c = 3;
  }
  if (d.h == out_h && d.w == out_w)
    std::memcpy(out, d.data.data(), d.data.size());
  else
    resize_bilinear_u8(d.data.data(), d.h, d.w, 3, out, out_h, out_w);
  return FD_OK;
} catch (...) {
  return FD_ERR_DECODE;
}

// Decode a label image, nearest-resize, write int32 trainIds into out
// (out_h*out_w).
//
// lut == NULL (pre-converted trainId labels): grayscale/palette values pass
// through raw — numpy-on-PIL semantics for "L"/"P" images; RGB labels are
// rejected (the caller falls back to PIL, which warns and converts).
//
// lut != NULL (on-the-fly RGB color labels): the file is decoded TO RGB
// (palette and grayscale expanded, exactly like PIL convert("RGB")) and
// every pixel mapped through lut (256^3 u8, index r<<16|g<<8|b) — so
// palette-encoded color labels (the official GTA5 ones) map by their
// palette COLORS, never by raw palette indices.
int fd_load_label(const char* path, const unsigned char* lut, int* out,
                  int out_h, int out_w) try {
  Decoded d;
  int rc = decode_file(path, d, /*want_rgb=*/lut != nullptr);
  if (rc != FD_OK) return rc;
  if (d.c == 3 && !lut) return FD_ERR_RGB_LABEL_NEEDS_LUT;
  std::vector<unsigned char> resized;
  const unsigned char* px = d.data.data();
  int h = d.h, w = d.w;
  if (h != out_h || w != out_w) {
    resized.resize(static_cast<size_t>(out_h) * out_w * d.c);
    resize_nearest_u8(px, h, w, d.c, resized.data(), out_h, out_w);
    px = resized.data();
    h = out_h;
    w = out_w;
  }
  size_t n = static_cast<size_t>(out_h) * out_w;
  if (d.c == 1) {
    for (size_t i = 0; i < n; ++i) out[i] = px[i];
  } else {
    for (size_t i = 0; i < n; ++i) {
      const unsigned char* p = px + i * 3;
      out[i] = lut[(static_cast<size_t>(p[0]) << 16) |
                   (static_cast<size_t>(p[1]) << 8) | p[2]];
    }
  }
  return FD_OK;
} catch (...) {
  return FD_ERR_DECODE;
}

}  // extern "C"
