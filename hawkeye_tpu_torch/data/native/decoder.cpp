// Host-side JPEG decode + resize for the port's device pipeline.
//
// The port's own copy of the JAX package's decoder (same algorithm, so the
// two packages' FGDataset(decode_size=...) give the same bytes). The
// loader's threads call it through ctypes, with the GIL released for the
// call. Two things PIL does not do:
//   1. libjpeg DCT scaling: decode directly at m/8 of full resolution, the
//      smallest m whose shorter side still reaches the target; most of
//      CUB's ~500px images decode at a fraction of the full-res cost for a
//      512px target.
//   2. fused shorter-side resize + center-crop straight into the caller's
//      buffer (no intermediate allocations, bilinear).
//
// Build (hawkeye_tpu_torch/data/native_decoder.py does it at first use):
//   g++ -O3 -shared -fPIC decoder.cpp -ljpeg -o libhawkeye_decoder.so

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear sample of src (h x w x 3) at (fy, fx), clamped.
inline void sample(const uint8_t* src, int h, int w, float fy, float fx,
                   uint8_t* out) {
  fy = std::min(std::max(fy, 0.0f), static_cast<float>(h - 1));
  fx = std::min(std::max(fx, 0.0f), static_cast<float>(w - 1));
  int y0 = static_cast<int>(fy);
  int x0 = static_cast<int>(fx);
  int y1 = std::min(y0 + 1, h - 1);
  int x1 = std::min(x0 + 1, w - 1);
  float wy = fy - y0;
  float wx = fx - x0;
  for (int c = 0; c < 3; ++c) {
    float v00 = src[(y0 * w + x0) * 3 + c];
    float v01 = src[(y0 * w + x1) * 3 + c];
    float v10 = src[(y1 * w + x0) * 3 + c];
    float v11 = src[(y1 * w + x1) * 3 + c];
    float top = v00 * (1 - wx) + v01 * wx;
    float bot = v10 * (1 - wx) + v11 * wx;
    out[c] = static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
  }
}

}  // namespace

extern "C" {

// Decode `data[:len]`, resize shorter side to `target`, center-crop to
// target x target, write RGB uint8 into `out` (target*target*3 bytes).
// Returns 0 on success, nonzero on decode failure.
int decode_resize_center(const uint8_t* data, size_t len, int target,
                         uint8_t* out) {
  // Construct every non-trivial object BEFORE arming setjmp: the libjpeg
  // error handler longjmps back here, and a jump across in-scope vector
  // initializations would skip their destructors (leak per corrupt JPEG).
  // Constructed-before-setjmp objects are destroyed normally on the error
  // `return` path instead.
  std::vector<uint8_t> buf;
  std::vector<uint8_t> row;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;

  // DCT scaling: pick the smallest scale m/8 with
  // min(w, h) * m / 8 >= target (never decode smaller than the target).
  const int full_min = std::min(cinfo.image_width, cinfo.image_height);
  int m = 8;
  for (int cand = 1; cand <= 8; ++cand) {
    if (static_cast<long>(full_min) * cand >= static_cast<long>(target) * 8) {
      m = cand;
      break;
    }
  }
  cinfo.scale_num = m;
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int comps = cinfo.output_components;
  buf.resize(static_cast<size_t>(w) * h * 3);
  row.resize(static_cast<size_t>(w) * comps);
  uint8_t* rowp = row.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = buf.data() + static_cast<size_t>(y) * w * 3;
    if (comps == 3) {
      std::memcpy(dst, rowp, static_cast<size_t>(w) * 3);
    } else if (comps == 1) {  // grayscale → RGB
      for (int x = 0; x < w; ++x) {
        dst[x * 3 + 0] = dst[x * 3 + 1] = dst[x * 3 + 2] = rowp[x];
      }
    } else {  // CMYK etc: approximate by first 3 channels
      for (int x = 0; x < w; ++x) {
        dst[x * 3 + 0] = rowp[x * comps + 0];
        dst[x * 3 + 1] = rowp[x * comps + 1];
        dst[x * 3 + 2] = rowp[x * comps + 2];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // shorter-side scale + center crop, fused into one sampling loop
  const float scale = static_cast<float>(std::min(w, h)) / target;
  const float crop_w = target * scale;
  const float crop_h = target * scale;
  const float off_x = (w - crop_w) / 2.0f;
  const float off_y = (h - crop_h) / 2.0f;
  for (int oy = 0; oy < target; ++oy) {
    const float fy = off_y + (oy + 0.5f) * scale - 0.5f;
    for (int ox = 0; ox < target; ++ox) {
      const float fx = off_x + (ox + 0.5f) * scale - 0.5f;
      sample(buf.data(), h, w, fy, fx,
             out + (static_cast<size_t>(oy) * target + ox) * 3);
    }
  }
  return 0;
}

}  // extern "C"
