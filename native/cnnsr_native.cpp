// cnnsr_native — native runtime layer for the cnn_sr framework.
//
// The equivalent of the reference's native host runtime: where the
// reference used C++ for image IO (stb via opencl/UtilsOpenCL.cpp), JSON
// parsing (libs/cpp/gason.cpp) and host-side sample preparation
// (Main_cl.cpp prepare_image loop), this library provides:
//
//   * JPEG/PNG decode to RGBA8 (libjpeg/libpng/zlib) and JPEG encode
//   * Rec.601 luma extraction + per-image mean subtraction (the
//     extract_luma.cl / DataPipeline::subtract_mean host analog)
//   * a pthread-pooled batch sample loader that decodes whole training
//     sets into caller-provided packed float32 buffers — the data-loader
//     feeding the jitted training step
//   * fast float-array JSON emit/parse for the parameters file
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (cnn_sr/native.py). All functions return 0 on success, negative
// error codes on failure.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <csetjmp>
#include <string>
#include <vector>
#include <thread>
#include <atomic>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// Image decode (force RGBA, like the reference's stbi_load with 4 channels —
// UtilsOpenCL.cpp:88-91)
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

static int decode_jpeg(FILE* f, std::vector<uint8_t>& out, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = (int)cinfo.output_width;
  *h = (int)cinfo.output_height;
  out.resize((size_t)(*w) * (*h) * 4);
  std::vector<uint8_t> row((size_t)(*w) * 3);
  uint8_t* rowp = row.data();
  for (int y = 0; y < *h; y++) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out.data() + (size_t)y * (*w) * 4;
    for (int x = 0; x < *w; x++) {
      dst[x * 4 + 0] = row[x * 3 + 0];
      dst[x * 4 + 1] = row[x * 3 + 1];
      dst[x * 4 + 2] = row[x * 3 + 2];
      dst[x * 4 + 3] = 255;
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

static int decode_png(FILE* f, std::vector<uint8_t>& out, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  // normalize anything to 8-bit RGBA
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_gray_to_rgb(png);
  png_set_add_alpha(png, 0xFF, PNG_FILLER_AFTER);
  png_read_update_info(png, info);
  *w = (int)png_get_image_width(png, info);
  *h = (int)png_get_image_height(png, info);
  out.resize((size_t)(*w) * (*h) * 4);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; y++) rows[y] = out.data() + (size_t)y * (*w) * 4;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

static int decode_file(const char* path, std::vector<uint8_t>& out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  int rc;
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = decode_jpeg(f, out, w, h);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rc = decode_png(f, out, w, h);
  } else {
    rc = -4;  // unknown format
  }
  fclose(f);
  return rc;
}

static int read_header_jpeg(FILE* f, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int)cinfo.image_width;
  *h = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

static int read_header_png(FILE* f, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *w = (int)png_get_image_width(png, info);
  *h = (int)png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Query dimensions (header-only, no pixel decode) for the two-phase
// ctypes API.
int cnnsr_image_size(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  int rc;
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = read_header_jpeg(f, w, h);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rc = read_header_png(f, w, h);
  } else {
    rc = -4;
  }
  fclose(f);
  return rc;
}

int cnnsr_decode_rgba(const char* path, uint8_t* dst, int w, int h) {
  std::vector<uint8_t> px;
  int dw, dh;
  int rc = decode_file(path, px, &dw, &dh);
  if (rc != 0) return rc;
  if (dw != w || dh != h) return -5;
  memcpy(dst, px.data(), px.size());
  return 0;
}

// JPEG encode (quality 1..100), RGB8 rows straight into libjpeg.
int cnnsr_encode_jpeg(const char* path, const uint8_t* rgb, int w, int h,
                      int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = (JDIMENSION)w;
  cinfo.image_height = (JDIMENSION)h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   (size_t)cinfo.next_scanline * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Color ops (host-side batch preprocessing)
// ---------------------------------------------------------------------------

// Rec.601 luma from RGBA8; optional /255 normalization (extract_luma.cl:17-21)
// and optional per-image mean subtraction (DataPipeline.cpp:268-280).
#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>

// 8 RGBA pixels per iteration: byte-lane masks/shifts deinterleave the
// channels, one FMA chain forms the Rec.601 dot product, and the running
// sum accumulates per-vector into a double (the scalar loop's double
// reduction is what stops the compiler auto-vectorizing it).
__attribute__((target("avx2,fma")))
static double extract_luma_avx2(const uint8_t* rgba, float* luma,
                                int64_t npx, int normalize) {
  const __m256 cr = _mm256_set1_ps(0.299f);
  const __m256 cg = _mm256_set1_ps(0.587f);
  const __m256 cb = _mm256_set1_ps(0.114f);
  const __m256 inv = _mm256_set1_ps(1.0f / 255.0f);
  const __m256i mask = _mm256_set1_epi32(0xFF);
  double sum = 0.0;
  int64_t i = 0;
  // chunked vector accumulation: one horizontal reduce per 4096
  // iterations (a per-iteration hadd chain measured scalar-speed);
  // chunk partial sums stay well inside f32's exact-integer range
  while (i + 8 <= npx) {
    int64_t end = i + ((npx - i) / 8) * 8;
    if (end - i > 8 * 4096) end = i + 8 * 4096;
    __m256 vsum = _mm256_setzero_ps();
    for (; i < end; i += 8) {
      __m256i px = _mm256_loadu_si256((const __m256i*)(rgba + i * 4));
      __m256 rf = _mm256_cvtepi32_ps(_mm256_and_si256(px, mask));
      __m256 gf = _mm256_cvtepi32_ps(
          _mm256_and_si256(_mm256_srli_epi32(px, 8), mask));
      __m256 bf = _mm256_cvtepi32_ps(
          _mm256_and_si256(_mm256_srli_epi32(px, 16), mask));
      __m256 v = _mm256_fmadd_ps(
          rf, cr, _mm256_fmadd_ps(gf, cg, _mm256_mul_ps(bf, cb)));
      if (normalize) v = _mm256_mul_ps(v, inv);
      _mm256_storeu_ps(luma + i, v);
      vsum = _mm256_add_ps(vsum, v);
    }
    __m128 s = _mm_add_ps(_mm256_castps256_ps128(vsum),
                          _mm256_extractf128_ps(vsum, 1));
    s = _mm_hadd_ps(s, s);
    s = _mm_hadd_ps(s, s);
    sum += (double)_mm_cvtss_f32(s);
  }
  const float inv255 = 1.0f / 255.0f;
  for (; i < npx; i++) {
    float v = 0.299f * rgba[i * 4 + 0] + 0.587f * rgba[i * 4 + 1] +
              0.114f * rgba[i * 4 + 2];
    if (normalize) v *= inv255;
    luma[i] = v;
    sum += v;
  }
  return sum;
}
#endif

void cnnsr_extract_luma(const uint8_t* rgba, float* luma, int64_t npx,
                        int normalize, int subtract_mean) {
  const float inv255 = 1.0f / 255.0f;
  double sum = 0.0;
#if defined(__x86_64__) || defined(_M_X64)
  if (__builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma")) {
    sum = extract_luma_avx2(rgba, luma, npx, normalize);
  } else
#endif
  {
    for (int64_t i = 0; i < npx; i++) {
      float v = 0.299f * rgba[i * 4 + 0] + 0.587f * rgba[i * 4 + 1] +
                0.114f * rgba[i * 4 + 2];
      if (normalize) v *= inv255;
      luma[i] = v;
      sum += v;
    }
  }
  if (subtract_mean) {
    float mean = (float)(sum / (double)npx);
    for (int64_t i = 0; i < npx; i++) luma[i] -= mean;
  }
}

// ---------------------------------------------------------------------------
// Threaded batch sample loader: decode + luma for a whole training set.
// Each sample writes into its (h*w) slice of the packed output buffers.
// Paths are NUL-separated concatenations (ctypes-friendly).
// ---------------------------------------------------------------------------

int cnnsr_load_sample_batch(const char* paths, int n_samples, int w, int h,
                            float* out, int normalize, int subtract_mean,
                            int n_threads) {
  std::vector<const char*> plist(n_samples);
  {
    const char* p = paths;
    for (int i = 0; i < n_samples; i++) {
      plist[i] = p;
      p += strlen(p) + 1;
    }
  }
  if (n_threads <= 0) {
    // hardware_concurrency() may legally return 0 ("not computable")
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n_samples) n_threads = n_samples > 0 ? n_samples : 1;

  std::atomic<int> next(0);
  std::atomic<int> first_err(0);
  auto worker = [&]() {
    std::vector<uint8_t> px;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_samples) break;
      int dw, dh;
      int rc = decode_file(plist[i], px, &dw, &dh);
      if (rc != 0 || dw != w || dh != h) {
        int expected = 0;
        first_err.compare_exchange_strong(expected, rc != 0 ? rc : -5);
        continue;
      }
      cnnsr_extract_luma(px.data(), out + (int64_t)i * w * h, (int64_t)w * h,
                         normalize, subtract_mean);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return first_err.load();
}

// ---------------------------------------------------------------------------
// Fast float-array JSON codec (the gason/dump_vector analog for the
// parameters file — ConfigBasedDataPipeline.cpp:388-465).
// ---------------------------------------------------------------------------

// Serialize n floats as "v, v, v" with shortest-round-trip precision.
// Returns bytes written (excluding NUL), or -1 if cap too small.
int64_t cnnsr_format_floats(const float* vals, int64_t n, char* dst, int64_t cap) {
  int64_t off = 0;
  char buf[48];
  for (int64_t i = 0; i < n; i++) {
    // %.9g is sufficient for exact float32 round-trip
    int len = snprintf(buf, sizeof buf, "%.9g", (double)vals[i]);
    int64_t need = len + (i + 1 < n ? 2 : 0);
    if (off + need + 1 > cap) return -1;
    memcpy(dst + off, buf, (size_t)len);
    off += len;
    if (i + 1 < n) {
      dst[off++] = ',';
      dst[off++] = ' ';
    }
  }
  dst[off] = '\0';
  return off;
}

// Parse up to n comma/whitespace-separated floats from src; returns count.
int64_t cnnsr_parse_floats(const char* src, float* dst, int64_t n) {
  const char* p = src;
  int64_t count = 0;
  while (count < n) {
    char* end;
    double v = strtod(p, &end);
    if (end == p) break;
    dst[count++] = (float)v;
    p = end;
    while (*p == ',' || *p == ' ' || *p == '\n' || *p == '\t' || *p == '\r') p++;
  }
  return count;
}

}  // extern "C"
