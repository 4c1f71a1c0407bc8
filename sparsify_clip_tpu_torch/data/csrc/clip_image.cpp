// Native image pipeline for sparsify_clip_tpu: JPEG decode + crop +
// Pillow-compatible antialiased bilinear resize + horizontal flip +
// CLIP normalization, in one pass over the pixels.
//
// Replaces the host-side PIL path (data/transforms.py, itself the
// capability twin of the reference's PIL + torchvision C++ transforms,
// /root/reference/sparsify_clip.py:1007-1018).  The Python transforms
// remain the behavioral golden; tests/test_native_imaging.py pins this
// implementation against them.
//
// Random crop/flip PARAMETERS are sampled in Python (same per-
// (seed, epoch, index) streams as the PIL path, so data order and
// caption choice are backend-invariant); this library only does the
// heavy pixel work.  All functions are thread-safe and reentrant —
// Python's loader threads call in parallel (ctypes releases the GIL).
//
// Resize algorithm: separable triangle-filter convolution with support
// scaled by the downsampling factor — the algorithm Pillow uses for
// Image.resize(..., BILINEAR) since 2.7 (antialiased).  Accumulation
// here is double precision where Pillow uses fixed point, so outputs
// can differ from PIL by ~1 of 255 per channel; tests use tolerances.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first

#include <jpeglib.h>

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void err_silent(j_common_ptr, int) {}
void err_silent_msg(j_common_ptr) {}

// Decode rows [row0, row1) only (libjpeg-turbo jpeg_skip_scanlines;
// row0/row1 < 0 decodes everything).  *out_row0 reports the first row
// actually present in `out` (skip granularity is the iMCU height, so
// a few extra rows may be included).
int decode_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
               int* w, int* h, int row0, int row1, int* out_row0) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_silent;
  jerr.pub.output_message = err_silent_msg;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  if (row0 < 0 || row1 > *h) {
    row0 = 0;
    row1 = *h;
  }
  int first = 0;
  if (row0 > 0) {
    // skip granularity: whatever the library actually skipped
    JDIMENSION skipped =
        jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(row0));
    first = static_cast<int>(skipped);
  }
  *out_row0 = first;
  const int nrows = row1 - first;
  out.resize(static_cast<size_t>(*w) * nrows * 3);
  while (static_cast<int>(cinfo.output_scanline) < row1) {
    uint8_t* row = out.data() +
                   static_cast<size_t>(static_cast<int>(cinfo.output_scanline) -
                                       first) * *w * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  if (static_cast<int>(cinfo.output_scanline) < *h) {
    jpeg_skip_scanlines(
        &cinfo, static_cast<JDIMENSION>(*h - cinfo.output_scanline));
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Triangle-filter coefficient table over the (possibly fractional)
// input window [in0, in1), Pillow box semantics.
struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // (xmin, count) per output index
  std::vector<double> k;     // ksize weights per output index
};

void make_coeffs(int in_size, double in0, double in1, int out_size,
                 Coeffs& c) {
  const double scale = (in1 - in0) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support = 1
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);
  const double ss = 1.0 / filterscale;
  // crop().resize() semantics: the filter window clamps at the crop
  // edges, never sampling pixels outside the box
  int lo = static_cast<int>(std::floor(in0));
  if (lo < 0) lo = 0;
  int hi = static_cast<int>(std::ceil(in1));
  if (hi > in_size) hi = in_size;
  for (int xx = 0; xx < out_size; xx++) {
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < lo) xmin = lo;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > hi) xmax = hi;
    xmax -= xmin;
    double* k = &c.k[static_cast<size_t>(xx) * c.ksize];
    double wsum = 0.0;
    for (int x = 0; x < xmax; x++) {
      const double t = (x + xmin - center + 0.5) * ss;
      const double w = t < 0 ? (t > -1 ? 1 + t : 0) : (t < 1 ? 1 - t : 0);
      k[x] = w;
      wsum += w;
    }
    if (wsum != 0.0) {
      for (int x = 0; x < xmax; x++) k[x] /= wsum;
    }
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
}

// CLIP pixel statistics (sparsify_clip.py:1003-1004).
const double kMean[3] = {0.48145466, 0.4578275, 0.40821073};
const double kStd[3] = {0.26862954, 0.26130258, 0.27577711};

}  // namespace

extern "C" {

// Read only the JPEG header: fills (*w, *h); returns 0 on success.
int clip_jpeg_dims(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = err_silent;
  jerr.pub.output_message = err_silent_msg;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + crop(top, left, ch, cw; ch<=0 -> full image) + resize to
// (out_size, out_size) + optional horizontal flip, writing HWC output:
//   out_mode 0: float32, CLIP-normalized ((v/255 - mean) / std)
//   out_mode 1: uint8 (device_augment staging path)
// Returns 0 on success, 1 on decode error, 2 on bad crop window.
int clip_decode_transform(const uint8_t* data, size_t len, int top, int left,
                          int ch, int cw, int out_size, int flip,
                          int out_mode, void* out_buf) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0, row_base = 0;
  // decode only the crop's rows (iMCU-aligned) when a crop is given
  const int want0 = (ch > 0 && top >= 0) ? top : -1;
  const int want1 = (ch > 0 && top >= 0) ? top + ch : -1;
  if (decode_rgb(data, len, rgb, &w, &h, want0, want1, &row_base)) return 1;
  if (ch <= 0 || cw <= 0) {
    top = 0;
    left = 0;
    ch = h;
    cw = w;
  }
  if (top < 0 || left < 0 || top + ch > h || left + cw > w) return 2;

  Coeffs cx, cy;
  make_coeffs(w, left, left + cw, out_size, cx);
  make_coeffs(h, top, top + ch, out_size, cy);

  // Horizontal pass over the input rows the vertical pass can touch.
  const int ymin0 = cy.bounds[0];
  const int ymax0 = cy.bounds[(out_size - 1) * 2] +
                    cy.bounds[(out_size - 1) * 2 + 1];
  const int nrows = ymax0 - ymin0;
  std::vector<double> tmp(static_cast<size_t>(nrows) * out_size * 3);
  for (int y = 0; y < nrows; y++) {
    const uint8_t* src =
        rgb.data() + static_cast<size_t>(y + ymin0 - row_base) * w * 3;
    double* dst = tmp.data() + static_cast<size_t>(y) * out_size * 3;
    for (int xx = 0; xx < out_size; xx++) {
      const int xmin = cx.bounds[xx * 2];
      const int cnt = cx.bounds[xx * 2 + 1];
      const double* k = &cx.k[static_cast<size_t>(xx) * cx.ksize];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int x = 0; x < cnt; x++) {
        const uint8_t* p = src + static_cast<size_t>(xmin + x) * 3;
        acc0 += p[0] * k[x];
        acc1 += p[1] * k[x];
        acc2 += p[2] * k[x];
      }
      dst[xx * 3 + 0] = acc0;
      dst[xx * 3 + 1] = acc1;
      dst[xx * 3 + 2] = acc2;
    }
  }

  // Vertical pass + flip + output conversion.
  float* out_f = static_cast<float*>(out_buf);
  uint8_t* out_u = static_cast<uint8_t*>(out_buf);
  for (int yy = 0; yy < out_size; yy++) {
    const int ymin = cy.bounds[yy * 2] - ymin0;
    const int cnt = cy.bounds[yy * 2 + 1];
    const double* k = &cy.k[static_cast<size_t>(yy) * cy.ksize];
    for (int xx = 0; xx < out_size; xx++) {
      const int ox = flip ? (out_size - 1 - xx) : xx;
      double acc[3] = {0, 0, 0};
      for (int y = 0; y < cnt; y++) {
        const double* p =
            tmp.data() + (static_cast<size_t>(ymin + y) * out_size + xx) * 3;
        acc[0] += p[0] * k[y];
        acc[1] += p[1] * k[y];
        acc[2] += p[2] * k[y];
      }
      const size_t o = (static_cast<size_t>(yy) * out_size + ox) * 3;
      if (out_mode == 0) {
        for (int ci = 0; ci < 3; ci++) {
          double v = acc[ci];
          if (v < 0) v = 0;
          if (v > 255) v = 255;
          out_f[o + ci] =
              static_cast<float>((v / 255.0 - kMean[ci]) / kStd[ci]);
        }
      } else {
        for (int ci = 0; ci < 3; ci++) {
          double v = acc[ci] + 0.5;
          if (v < 0) v = 0;
          if (v > 255) v = 255;
          out_u[o + ci] = static_cast<uint8_t>(v);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
