// enloader: native image decode + resize for the PyTorch port (the port's
// own copy of native/enloader.cpp, the same code and C ABI).
//
// It decodes a whole batch in parallel C++ threads (JPEG via libjpeg, PNG
// via libpng) and resizes bilinearly (cv2-compatible half-pixel-center
// sampling) straight into the caller's preallocated uint8 BGR batch
// buffer, which BatchLoader hands to torch without another copy. No GIL is
// held while it runs.
//
// C ABI (ctypes-friendly):
//   en_decode_batch(paths, n, out, H, W, n_threads) -> number decoded OK
//   en_decode_batch_ex(paths, n, out, H, W, n_threads, flags): flags bit 0
//     takes the DCT-prescaled (fast, approximate) JPEG path
//   en_version() -> int
//
// Failed/missing images leave their batch slot zeroed (same contract as
// the Python loader).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // BGR interleaved
  int w = 0, h = 0;
};

// ---------------------------------------------------------------- JPEG --

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// target_h/target_w > 0 enable DCT-domain scaled decode (libjpeg
// scale_num/8): the decoder emits the smallest M/8-scaled image that is
// still >= the target in both dims, cutting IDCT + color-convert work up
// to ~4x for 2:1 pipelines. Output then goes through the same bilinear
// resize, so geometry stays cv2-like, but the DCT low-pass differs from
// full-decode-then-bilinear by a few gray levels — opt-in only
// (en_decode_batch_ex flags bit 0 / BatchLoader fast_decode).
bool decode_jpeg(FILE* f, Image* out, int target_h, int target_w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (target_h > 0 && target_w > 0) {
    int m = 8;  // scale_num: output = ceil(dim * m / 8)
    while (m > 1 && int(cinfo.image_height) * (m - 1) / 8 >= target_h &&
           int(cinfo.image_width) * (m - 1) / 8 >= target_w)
      --m;
#ifndef JCS_EXTENSIONS
    // Plain libjpeg (pre-v7) only honors 1/1, 1/2, 1/4, 1/8 and silently
    // recomputes other M/8 ratios — possibly to something SMALLER than
    // the target, turning the bilinear pass into an upscale. Round m up
    // to the next power of two so the decode is always >= target.
    // libjpeg-turbo (the JCS_EXTENSIONS build) honors all M/8.
    while (m != 1 && m != 2 && m != 4 && m != 8) ++m;
#endif
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
#ifdef JCS_EXTENSIONS
  // libjpeg-turbo: decode straight to BGR (cv2 channel order,
  // utils.py:13-21 parity) — no intermediate row buffer or swap pass.
  cinfo.out_color_space = JCS_EXT_BGR;
#else
  cinfo.out_color_space = JCS_RGB;
#endif
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
#ifdef JCS_EXTENSIONS
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = out->data.data()
        + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
#else
  std::vector<uint8_t> row(size_t(out->w) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = row.data();
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out->data.data()
        + size_t(cinfo.output_scanline - 1) * out->w * 3;
    // RGB -> BGR (cv2 channel order, utils.py:13-21 parity)
    for (int x = 0; x < out->w; ++x) {
      dst[x * 3 + 0] = row[x * 3 + 2];
      dst[x * 3 + 1] = row[x * 3 + 1];
      dst[x * 3 + 2] = row[x * 3 + 0];
    }
  }
#endif
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG --

bool decode_png(FILE* f, Image* out) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_set_strip_16(png);        // 16-bit -> 8-bit
  png_set_palette_to_rgb(png);  // palette -> RGB
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);     // drop alpha
  if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
      png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_bgr(png);             // BGR output directly
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// --------------------------------------------------------------- resize --

// Bilinear with half-pixel centers (cv2 INTER_LINEAR geometry).
// The horizontal source offsets/weights are identical for every row, so
// they are computed once into tables instead of per pixel (exact same
// arithmetic and output as the straightforward loop, ~2x faster).
void resize_bilinear(const Image& src, uint8_t* dst, int dh, int dw) {
  const float sx = float(src.w) / dw;
  const float sy = float(src.h) / dh;
  std::vector<int> x0t(dw), x1t(dw);
  std::vector<float> wxt(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = int(fx >= 0 ? fx : fx - 1);  // floor
    wxt[x] = fx - x0;
    x0t[x] = 3 * (x0 < 0 ? 0 : (x0 >= src.w ? src.w - 1 : x0));
    x1t[x] = 3 * (x0 + 1 < 0 ? 0 : (x0 + 1 >= src.w ? src.w - 1 : x0 + 1));
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(fy >= 0 ? fy : fy - 1);  // floor
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= src.h ? src.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= src.h ? src.h - 1 : y0 + 1);
    const uint8_t* r0 = src.data.data() + size_t(y0c) * src.w * 3;
    const uint8_t* r1 = src.data.data() + size_t(y1c) * src.w * 3;
    uint8_t* drow = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int x0c = x0t[x], x1c = x1t[x];
      const float wx = wxt[x];
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * r0[x0c + c] + wx * r0[x1c + c])
                  + wy * ((1 - wx) * r1[x0c + c] + wx * r1[x1c + c]);
        drow[x * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

bool decode_file(const char* path, Image* out, int target_h, int target_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out, target_h, target_w);
  } else if (magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok && out->w > 0 && out->h > 0;
}

}  // namespace

extern "C" {

int en_version() { return 2; }

// Decode n images into out[n, H, W, 3] uint8 BGR. Returns #decoded OK.
// flags bit 0: fast JPEG decode (DCT-domain M/8 prescale — approximate,
// see decode_jpeg).
int en_decode_batch_ex(const char** paths, int n, uint8_t* out, int H,
                       int W, int n_threads, int flags) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> ok_count{0};
  const size_t img_bytes = size_t(H) * W * 3;
  const bool fast = flags & 1;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      Image img;
      uint8_t* slot = out + size_t(i) * img_bytes;
      if (decode_file(paths[i], &img, fast ? H : 0, fast ? W : 0)) {
        if (img.w == W && img.h == H) {
          std::memcpy(slot, img.data.data(), img_bytes);
        } else {
          resize_bilinear(img, slot, H, W);
        }
        ok_count.fetch_add(1);
      } else {
        std::memset(slot, 0, img_bytes);
        std::fprintf(stderr, "enloader: image does not exist or failed to "
                             "decode: %s\n", paths[i]);
      }
    }
  };

  int threads = n_threads < n ? n_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return ok_count.load();
}

// Original exact-decode ABI (kept for compatibility).
int en_decode_batch(const char** paths, int n, uint8_t* out, int H, int W,
                    int n_threads) {
  return en_decode_batch_ex(paths, n, out, H, W, n_threads, 0);
}

}  // extern "C"
