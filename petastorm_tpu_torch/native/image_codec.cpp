// Batched PNG/JPEG decoder for CompressedImageCodec (petastorm_tpu_torch).
//
// The port's own copy of petastorm_tpu/native/image_codec.cpp: the same
// probe, decode and resample code, so both packages give the same pixels.
// One native call decodes a whole column's worth of encoded cells:
//   * the GIL is released for the entire column, so reader pool threads decode
//     row groups truly in parallel;
//   * pixels land directly in caller-allocated numpy memory in RGB order
//     (libjpeg/libpng native order) — no BGR swap pass, no intermediate copy;
//   * an optional internal thread pool fans decode out across images for
//     single-threaded callers (dummy pool, benchmarks).
//
// Supported: JPEG gray/RGB (8-bit), PNG gray/RGB (8/16-bit, incl. 1/2/4-bit
// gray expansion and interlace). Anything else (palette, alpha, CMYK, exotic
// formats) returns the failing index and the Python caller falls back to the
// per-image OpenCV path — matching what CompressedImageCodec.encode can write.
//
// What this copy adds: it builds with whatever image libraries the host has.
//   * libjpeg (jpeglib.h) absent: JPEG cells are refused at probe time with an
//     error naming libjpeg;
//   * libpng (png.h) absent: interlaced and sub-8-bit PNGs (the ones the
//     first-party fast path does not take) are refused the same way;
//   * libdeflate absent: the PNG fast path inflates with zlib's uncompress(),
//     which gives the same bytes; zlib.h may be absent too, since the
//     prototype is declared here and the library is the libz.so.1 that
//     CPython's zlib module loads.
// pstpu_img_features() reports what the build holds. Each PSTPU_HAVE_* macro
// may be forced to 0 on the command line to build a reduced library.
//
// Build: petastorm_tpu_torch/native/build.py (build_img), at first use.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifndef PSTPU_HAVE_JPEG
#if __has_include(<jpeglib.h>)
#define PSTPU_HAVE_JPEG 1
#else
#define PSTPU_HAVE_JPEG 0
#endif
#endif

#ifndef PSTPU_HAVE_PNG
#if __has_include(<png.h>)
#define PSTPU_HAVE_PNG 1
#else
#define PSTPU_HAVE_PNG 0
#endif
#endif

#ifndef PSTPU_HAVE_DEFLATE
#if __has_include(<libdeflate.h>)
#define PSTPU_HAVE_DEFLATE 1
#else
#define PSTPU_HAVE_DEFLATE 0
#endif
#endif

#if PSTPU_HAVE_JPEG
// jpeglib.h needs FILE and size_t declared before it
#include <cstdio>
#include <jpeglib.h>
#endif
#if PSTPU_HAVE_PNG
#include <png.h>
#endif
#if PSTPU_HAVE_DEFLATE
#include <libdeflate.h>
#elif __has_include(<zlib.h>)
#include <zlib.h>
#else
// zlib's one-shot inflate, as zlib.h declares it (uLongf = unsigned long,
// Bytef = unsigned char); Z_OK is 0
extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len,
                          const unsigned char* source, unsigned long source_len);
#endif

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Probing: header-only dimension/type sniffing, no decode.
// info layout per image: [width, height, channels, bit_depth]
// ---------------------------------------------------------------------------

constexpr uint8_t kPngMagic[8] = {137, 'P', 'N', 'G', 13, 10, 26, 10};
// PNG IHDR colour types (png.h's PNG_COLOR_TYPE_GRAY / _RGB)
constexpr int kPngColorGray = 0;
constexpr int kPngColorRgb = 2;

// the last failure's message, per calling thread; probe refusals that a build
// without some library makes set it too, so the caller can name the library
thread_local std::string g_error;

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

uint16_t be16(const uint8_t* p) { return (uint16_t(p[0]) << 8) | p[1]; }

// 0 = ok, -1 = unsupported/corrupt
int probe_png(const uint8_t* data, uint64_t len, int32_t* info) {
  if (len < 33) return -1;  // signature + IHDR
  // IHDR must be the first chunk: length(4) type(4) at offset 8
  if (be32(data + 8) != 13 || std::memcmp(data + 12, "IHDR", 4) != 0) return -1;
  const uint32_t w = be32(data + 16);
  const uint32_t h = be32(data + 20);
  const int bit_depth = data[24];
  const int color_type = data[25];
  if (w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24)) return -1;
  if (uint64_t(w) * h > (1ull << 28)) return -1;  // cap output allocations
  int channels;
  switch (color_type) {
    case kPngColorGray:
      channels = 1;
      // depth drives the decode-side bpp; an invalid value here would size the
      // unfilter wider than the Python-allocated output buffer
      if (bit_depth != 1 && bit_depth != 2 && bit_depth != 4 && bit_depth != 8 &&
          bit_depth != 16) return -1;
      break;
    case kPngColorRgb:
      channels = 3;
      if (bit_depth != 8 && bit_depth != 16) return -1;
      break;
    default:
      return -1;  // palette/alpha -> caller falls back to OpenCV
  }
#if !PSTPU_HAVE_PNG
  // the fast path takes non-interlaced 8/16-bit images only; the rest need
  // libpng's decoder
  if (data[28] != 0 || bit_depth < 8) {
    g_error = "interlaced or sub-8-bit png needs libpng, which this build lacks";
    return -1;
  }
#endif
  // A tRNS chunk on gray/RGB would add an alpha channel under cv2 semantics;
  // it is legal-but-rare — scan the chunk list and bail out if present.
  uint64_t pos = 33;
  while (pos + 8 <= len) {
    const uint32_t chunk_len = be32(data + pos);
    if (std::memcmp(data + pos + 4, "tRNS", 4) == 0) return -1;
    if (std::memcmp(data + pos + 4, "IDAT", 4) == 0) break;  // past metadata
    pos += 12ull + chunk_len;
  }
  info[0] = int32_t(w);
  info[1] = int32_t(h);
  info[2] = channels;
  info[3] = bit_depth < 8 ? 8 : bit_depth;  // 1/2/4-bit gray expands to 8
  return 0;
}

// Scaled JPEG decode: libjpeg decodes at m/8 of full size (m=1..8) nearly for
// free — the IDCT simply produces fewer samples, so most pixels are never
// computed. Given a minimum output size, pick the smallest m whose scaled
// dims still cover it (so the only remaining host resize is a small downscale).
// m=8 == full size; an image already smaller than the minimum stays full size.
int jpeg_choose_scale(int full_w, int full_h, int min_w, int min_h) {
  if (min_w <= 0 || min_h <= 0) return 8;
  for (int m = 1; m < 8; m++) {
    // jdiv_round_up, exactly as jpeg_calc_output_dimensions computes it
    const long w = (long(full_w) * m + 7) / 8;
    const long h = (long(full_h) * m + 7) / 8;
    if (w >= min_w && h >= min_h) return m;
  }
  return 8;
}

int probe_jpeg(const uint8_t* data, uint64_t len, int32_t* info) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  uint64_t pos = 2;
  while (pos + 4 <= len) {
    if (data[pos] != 0xFF) return -1;
    uint8_t marker = data[pos + 1];
    if (marker == 0xFF) { pos++; continue; }  // fill bytes
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) { pos += 2; continue; }
    const uint64_t seg_len = be16(data + pos + 2);
    const bool is_sof = (marker >= 0xC0 && marker <= 0xCF) &&
                        marker != 0xC4 && marker != 0xC8 && marker != 0xCC;
    if (is_sof) {
      if (pos + 2 + seg_len > len || seg_len < 8) return -1;
      const int precision = data[pos + 4];
      const uint16_t h = be16(data + pos + 5);
      const uint16_t w = be16(data + pos + 7);
      const int ncomp = data[pos + 9];
      if (precision != 8 || w == 0 || h == 0) return -1;
      if (ncomp != 1 && ncomp != 3) return -1;  // CMYK etc. -> fallback
      info[0] = w;
      info[1] = h;
      info[2] = ncomp;
      info[3] = 8;
      return 0;  // caller applies jpeg_choose_scale to info when a hint is set
    }
    pos += 2 + seg_len;
  }
  return -1;
}

int probe_one(const uint8_t* data, uint64_t len, int32_t* info, int min_w, int min_h) {
  if (len >= 8 && std::memcmp(data, kPngMagic, 8) == 0) return probe_png(data, len, info);
  const int rc = probe_jpeg(data, len, info);
  if (rc != 0) return rc;
#if !PSTPU_HAVE_JPEG
  g_error = "jpeg needs libjpeg, which this build lacks";
  return -1;
#endif
  // report post-scale output dims so the caller allocates the scaled buffer
  const int m = jpeg_choose_scale(info[0], info[1], min_w, min_h);
  if (m < 8) {
    info[0] = int32_t((long(info[0]) * m + 7) / 8);
    info[1] = int32_t((long(info[1]) * m + 7) / 8);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Fast PNG path: whole-IDAT inflate with libdeflate (~2x zlib's streaming
// inflate; zlib's one-shot uncompress() where the build has no libdeflate)
// + first-party row unfiltering. Covers what our encoder writes:
// non-interlaced 8/16-bit gray/RGB. Interlaced or sub-8-bit images take the
// libpng path below.
// ---------------------------------------------------------------------------

inline uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
  // branchless (cmov-friendly): the Paeth chain is the serial bottleneck of
  // filtered rows, so mispredicted branches here dominate whole-image decode
  const int p = int(a) + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  const uint8_t bc = pb <= pc ? b : c;
  const int pbc = pb <= pc ? pb : pc;
  return pa <= pbc ? a : bc;
}

// Per-filter row reconstruction, templated on bytes-per-pixel so the inner
// loops unroll with constant stride and the BPP independent channel chains
// overlap in the pipeline. src points past the filter byte; prev is the
// reconstructed previous row (nullptr on the first row).
template <int BPP>
void unfilter_sub(const uint8_t* src, uint8_t* cur, uint64_t rowbytes) {
  std::memcpy(cur, src, BPP);
  for (uint64_t i = BPP; i < rowbytes; i++) cur[i] = src[i] + cur[i - BPP];
}

template <int BPP>
void unfilter_avg(const uint8_t* src, const uint8_t* prev, uint8_t* cur, uint64_t rowbytes) {
  if (!prev) {
    std::memcpy(cur, src, BPP);
    for (uint64_t i = BPP; i < rowbytes; i++) cur[i] = src[i] + uint8_t(cur[i - BPP] >> 1);
    return;
  }
  for (int i = 0; i < BPP; i++) cur[i] = src[i] + uint8_t(prev[i] >> 1);
  for (uint64_t i = BPP; i < rowbytes; i++) {
    cur[i] = src[i] + uint8_t((cur[i - BPP] + prev[i]) >> 1);
  }
}

#if defined(__SSE2__)
// Vectorized Paeth for the RGB8 hot case: one pixel per iteration in 16-bit
// lanes, branchless predictor select. The pixel chain is inherently serial,
// but doing the per-pixel |..| / min / select math in one register pass beats
// the three interleaved scalar cmov chains by ~2x.
inline __m128i abs_i16(__m128i x) {
  return _mm_max_epi16(x, _mm_sub_epi16(_mm_setzero_si128(), x));
}

inline __m128i load_px4(const uint8_t* p) {  // 4 bytes -> 16-bit lanes
  int32_t v;
  std::memcpy(&v, p, 4);  // unaligned-safe; compiles to a single mov
  return _mm_unpacklo_epi8(_mm_cvtsi32_si128(v), _mm_setzero_si128());
}

// BPP must be 3: loads read 4 bytes per pixel and stores write 4, so the last
// pixel of the row is handled by the scalar caller (no out-of-bounds access).
inline void paeth3_px_sse2(const uint8_t* src_px, const uint8_t* prev_px, uint8_t* cur_px,
                           __m128i& a, __m128i& c) {
  const __m128i b = load_px4(prev_px);
  const __m128i x = load_px4(src_px);
  const __m128i p_a = _mm_sub_epi16(b, c);                 // p - a
  const __m128i p_b = _mm_sub_epi16(a, c);                 // p - b
  const __m128i pa = abs_i16(p_a);
  const __m128i pb = abs_i16(p_b);
  const __m128i pc = abs_i16(_mm_add_epi16(p_a, p_b));
  const __m128i mn = _mm_min_epi16(pc, _mm_min_epi16(pa, pb));
  const __m128i use_a = _mm_cmpeq_epi16(mn, pa);
  const __m128i use_b = _mm_andnot_si128(use_a, _mm_cmpeq_epi16(mn, pb));
  const __m128i pred = _mm_or_si128(
      _mm_and_si128(use_a, a),
      _mm_or_si128(_mm_and_si128(use_b, b),
                   _mm_andnot_si128(_mm_or_si128(use_a, use_b), c)));
  const __m128i d = _mm_and_si128(_mm_add_epi16(x, pred), _mm_set1_epi16(0xFF));
  const int32_t packed = _mm_cvtsi128_si32(_mm_packus_epi16(d, _mm_setzero_si128()));
  std::memcpy(cur_px, &packed, 4);
  a = d;
  c = b;
}
#endif  // __SSE2__

template <int BPP>
void unfilter_paeth(const uint8_t* src, const uint8_t* prev, uint8_t* cur, uint64_t rowbytes) {
  if (!prev) {  // paeth(a,0,0) == a: degenerates to Sub
    unfilter_sub<BPP>(src, cur, rowbytes);
    return;
  }
  for (int i = 0; i < BPP; i++) cur[i] = src[i] + prev[i];  // paeth(0,b,0) == b
#if defined(__SSE2__)
  if (BPP == 3 && rowbytes >= 8) {
    const uint64_t n_px = rowbytes / 3;
    // zero-padded temp: cur[3] is not written yet, and prev[3] belongs to the
    // next pixel — loading them directly would read uninitialized/irrelevant
    // bytes into lane 3 (harmless for the math, but UB and MSan-hostile)
    uint8_t first_px[4] = {cur[0], cur[1], cur[2], 0};
    uint8_t first_prev[4] = {prev[0], prev[1], prev[2], 0};
    __m128i a = load_px4(first_px);
    __m128i c = load_px4(first_prev);
    // stop one pixel early: the 4-byte loads/stores of the vector path would
    // touch one byte past the row at the final pixel
    for (uint64_t px = 1; px + 1 < n_px; px++) {
      paeth3_px_sse2(src + px * 3, prev + px * 3, cur + px * 3, a, c);
    }
    for (uint64_t i = (n_px - 1) * 3; i < rowbytes; i++) {
      cur[i] = src[i] + paeth(cur[i - 3], prev[i], prev[i - 3]);
    }
    return;
  }
#endif
  for (uint64_t i = BPP; i < rowbytes; i++) {
    cur[i] = src[i] + paeth(cur[i - BPP], prev[i], prev[i - BPP]);
  }
}

template <int BPP>
int unfilter_row_t(uint8_t filter, const uint8_t* src, const uint8_t* prev, uint8_t* cur,
                   uint64_t rowbytes) {
  switch (filter) {
    case 0:
      std::memcpy(cur, src, rowbytes);
      return 0;
    case 1:
      unfilter_sub<BPP>(src, cur, rowbytes);
      return 0;
    case 2:  // Up
      if (!prev) {
        std::memcpy(cur, src, rowbytes);
      } else {
        for (uint64_t i = 0; i < rowbytes; i++) cur[i] = src[i] + prev[i];
      }
      return 0;
    case 3:
      unfilter_avg<BPP>(src, prev, cur, rowbytes);
      return 0;
    case 4:
      unfilter_paeth<BPP>(src, prev, cur, rowbytes);
      return 0;
    default:
      return -1;
  }
}

int unfilter_row(uint8_t filter, const uint8_t* src, const uint8_t* prev, uint8_t* cur,
                 uint64_t rowbytes, int bpp) {
  switch (bpp) {  // every gray/RGB x 8/16-bit combination
    case 1: return unfilter_row_t<1>(filter, src, prev, cur, rowbytes);
    case 2: return unfilter_row_t<2>(filter, src, prev, cur, rowbytes);
    case 3: return unfilter_row_t<3>(filter, src, prev, cur, rowbytes);
    case 6: return unfilter_row_t<6>(filter, src, prev, cur, rowbytes);
    default: return -1;
  }
}

#if PSTPU_HAVE_DEFLATE
thread_local libdeflate_decompressor* g_inflater = nullptr;
#endif

// 1 = decoded, 0 = not eligible (caller uses libpng), -1 = error (err set)
int decode_png_fast(const uint8_t* data, uint64_t len, const int32_t* info, uint8_t* out,
                    std::string* err) {
  const int bit_depth = data[24];
  const int interlace = data[28];
  if (interlace != 0 || bit_depth < 8) return 0;
  const uint64_t w = info[0], h = info[1];
  const int channels = info[2];
  const int bpp = channels * (bit_depth / 8);
  const uint64_t rowbytes = w * bpp;

  // gather the IDAT payload spans (one zlib stream split across chunks)
  std::vector<std::pair<const uint8_t*, uint64_t>> spans;
  uint64_t zlen = 0;
  uint64_t pos = 8;
  while (pos + 12 <= len) {
    const uint32_t chunk_len = be32(data + pos);
    if (pos + 12ull + chunk_len > len) { *err = "truncated png chunk"; return -1; }
    if (std::memcmp(data + pos + 4, "IDAT", 4) == 0) {
      spans.emplace_back(data + pos + 8, chunk_len);
      zlen += chunk_len;
    } else if (std::memcmp(data + pos + 4, "IEND", 4) == 0) {
      break;
    }
    pos += 12ull + chunk_len;
  }
  if (spans.empty()) { *err = "png has no IDAT"; return -1; }

  const uint8_t* zdata;
  std::vector<uint8_t> zconcat;
  if (spans.size() == 1) {
    zdata = spans[0].first;
  } else {
    zconcat.resize(zlen);
    uint64_t off = 0;
    for (auto& s : spans) {
      std::memcpy(zconcat.data() + off, s.first, s.second);
      off += s.second;
    }
    zdata = zconcat.data();
  }

  const uint64_t raw_len = h * (rowbytes + 1);
  std::vector<uint8_t> raw(raw_len);
#if PSTPU_HAVE_DEFLATE
  if (!g_inflater) g_inflater = libdeflate_alloc_decompressor();
  size_t actual = 0;
  const libdeflate_result rc = libdeflate_zlib_decompress(
      g_inflater, zdata, zlen, raw.data(), raw_len, &actual);
  if (rc != LIBDEFLATE_SUCCESS || actual != raw_len) {
    *err = "png idat inflate failed";
    return -1;
  }
#else
  unsigned long actual = static_cast<unsigned long>(raw_len);
  const int rc = uncompress(raw.data(), &actual, zdata, static_cast<unsigned long>(zlen));
  if (rc != 0 || actual != raw_len) {
    *err = "png idat inflate failed";
    return -1;
  }
#endif

  const uint8_t* prev = nullptr;
  for (uint64_t y = 0; y < h; y++) {
    const uint8_t* src = raw.data() + y * (rowbytes + 1);
    uint8_t* cur = out + y * rowbytes;
    if (unfilter_row(src[0], src + 1, prev, cur, rowbytes, bpp) != 0) {
      *err = "bad png filter byte";
      return -1;
    }
    prev = cur;
  }
  if (bit_depth == 16) {  // PNG samples are big-endian; numpy wants LE
    const uint64_t n16 = h * rowbytes / 2;
    uint16_t* p = reinterpret_cast<uint16_t*>(out);
    for (uint64_t i = 0; i < n16; i++) p[i] = uint16_t((p[i] >> 8) | (p[i] << 8));
  }
  return 1;
}

// ---------------------------------------------------------------------------
// PNG decode (full libpng API; the simplified png_image API gamma-converts
// 16-bit samples, which would break raw-value parity with cv2).
// ---------------------------------------------------------------------------

#if PSTPU_HAVE_PNG
struct MemReader {
  const uint8_t* data;
  uint64_t len;
  uint64_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  auto* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->len) {
    png_error(png, "read past end of buffer");
    return;
  }
  std::memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

void png_on_error(png_structp png, png_const_charp msg) {
  auto* err = static_cast<std::string*>(png_get_error_ptr(png));
  *err = msg ? msg : "png error";
  longjmp(png_jmpbuf(png), 1);
}

void png_on_warning(png_structp, png_const_charp) {}

// 0 ok; fills `err` otherwise. Decodes into out (row-major, tightly packed).
int decode_png(const uint8_t* data, uint64_t len, const int32_t* info, uint8_t* out,
               std::string* err) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, err, png_on_error,
                                           png_on_warning);
  if (!png) { *err = "png_create_read_struct failed"; return -1; }
  png_infop pinfo = png_create_info_struct(png);
  if (!pinfo) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    *err = "png_create_info_struct failed";
    return -1;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {  // error path: libpng longjmps here
    png_destroy_read_struct(&png, &pinfo, nullptr);
    return -1;
  }
  MemReader reader{data, len, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, pinfo);

  const int color_type = png_get_color_type(png, pinfo);
  const int bit_depth = png_get_bit_depth(png, pinfo);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) {
    png_set_expand_gray_1_2_4_to_8(png);
  }
  if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian; numpy wants LE
  png_set_interlace_handling(png);
  png_read_update_info(png, pinfo);

  const uint64_t w = png_get_image_width(png, pinfo);
  const uint64_t h = png_get_image_height(png, pinfo);
  const uint64_t rowbytes = png_get_rowbytes(png, pinfo);
  const uint64_t expect_row =
      uint64_t(info[0]) * info[2] * (info[3] / 8);
  if (w != uint64_t(info[0]) || h != uint64_t(info[1]) || rowbytes != expect_row) {
    *err = "png dimensions changed between probe and decode";
    png_destroy_read_struct(&png, &pinfo, nullptr);
    return -1;
  }
  rows.resize(h);
  for (uint64_t y = 0; y < h; y++) rows[y] = out + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &pinfo, nullptr);
  return 0;
}
#else
int decode_png(const uint8_t*, uint64_t, const int32_t*, uint8_t*, std::string* err) {
  // unreachable after a successful probe, which refuses these images
  *err = "interlaced or sub-8-bit png needs libpng, which this build lacks";
  return -1;
}
#endif  // PSTPU_HAVE_PNG

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

#if PSTPU_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
  std::string* msg;
};

void jpeg_on_error(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  char buf[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, buf);
  *e->msg = buf;
  longjmp(e->jump, 1);
}

int decode_jpeg(const uint8_t* data, uint64_t len, const int32_t* info, uint8_t* out,
                std::string* err, int min_w, int min_h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  jerr.msg = err;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_on_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (info[2] == 1) ? JCS_GRAYSCALE : JCS_RGB;
  // same scale selection as probe_one, so output dims match the allocation
  cinfo.scale_num = jpeg_choose_scale(int(cinfo.image_width), int(cinfo.image_height),
                                      min_w, min_h);
  cinfo.scale_denom = 8;
  // (Measured dead ends, round 5: do_fancy_upsampling=FALSE and
  // JDCT_IFAST change nothing at m/8 scales — merged upsampling requires
  // unscaled geometry and the scaled IDCTs ignore dct_method — so the
  // defaults stay, keeping full-size decode byte-identical to cv2.imdecode
  // per the fuzz suite's exact-match contract.)
  jpeg_start_decompress(&cinfo);
  if (int(cinfo.output_width) != info[0] || int(cinfo.output_height) != info[1] ||
      int(cinfo.output_components) != info[2]) {
    *err = "jpeg dimensions changed between probe and decode";
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const uint64_t stride = uint64_t(info[0]) * info[2];
  // hand the library a batch of row pointers per call: per-scanline call
  // overhead is measurable at 1/8-scale where rows are tiny
  JSAMPROW rows[8];
  while (cinfo.output_scanline < cinfo.output_height) {
    const JDIMENSION base = cinfo.output_scanline;
    const int want = int(std::min<JDIMENSION>(8, cinfo.output_height - base));
    for (int r = 0; r < want; r++) rows[r] = out + uint64_t(base + r) * stride;
    jpeg_read_scanlines(&cinfo, rows, want);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#else
int decode_jpeg(const uint8_t*, uint64_t, const int32_t*, uint8_t*, std::string* err, int,
                int) {
  // unreachable after a successful probe, which refuses jpeg in this build
  *err = "jpeg needs libjpeg, which this build lacks";
  return -1;
}
#endif  // PSTPU_HAVE_JPEG

int decode_one(const uint8_t* data, uint64_t len, const int32_t* info, uint8_t* out,
               std::string* err, int min_w, int min_h);

// -- area resampling (separable, contribution-based; the cv2 INTER_AREA
// analog) -- used by the fused decode+resize path so the per-row Python
// resize transform disappears from the host hot loop.

void area_contribs(int in_len, int out_len, std::vector<int>& starts,
                   std::vector<int>& counts, std::vector<float>& weights,
                   int& max_count) {
  const double scale = double(in_len) / out_len;
  starts.resize(out_len);
  counts.resize(out_len);
  max_count = int(std::ceil(scale)) + 1;
  weights.assign(size_t(out_len) * max_count, 0.0f);
  for (int o = 0; o < out_len; o++) {
    const double lo = o * scale;
    const double hi = std::min(double(in_len), (o + 1) * scale);
    int s = std::min(in_len - 1, int(lo));
    int e = std::max(s + 1, std::min(in_len, int(std::ceil(hi))));
    starts[o] = s;
    counts[o] = e - s;
    const double span = hi - lo;
    float wsum = 0.0f;
    for (int p = s; p < e; p++) {
      // overlap of input pixel [p, p+1) with the output footprint [lo, hi)
      const double ov = std::min(double(p + 1), hi) - std::max(double(p), lo);
      const float w = float(std::max(0.0, ov) / (span > 0.0 ? span : 1.0));
      weights[size_t(o) * max_count + (p - s)] = w;
      wsum += w;
    }
    if (wsum > 0.0f) {  // normalize away float drift
      for (int k = 0; k < e - s; k++) weights[size_t(o) * max_count + k] /= wsum;
    }
  }
}

void resize_area(const uint8_t* src, int sw, int sh, int c, uint8_t* dst, int dw, int dh) {
  std::vector<int> xs, xc, ys, yc;
  std::vector<float> xw, yw;
  int xmax = 0, ymax = 0;
  area_contribs(sw, dw, xs, xc, xw, xmax);
  area_contribs(sh, dh, ys, yc, yw, ymax);
  // horizontal pass: [sh, sw, c] -> float [sh, dw, c]
  std::vector<float> tmp(size_t(sh) * dw * c);
  for (int y = 0; y < sh; y++) {
    const uint8_t* row = src + size_t(y) * sw * c;
    float* trow = tmp.data() + size_t(y) * dw * c;
    for (int ox = 0; ox < dw; ox++) {
      const int s = xs[ox], cnt = xc[ox];
      const float* w = xw.data() + size_t(ox) * xmax;
      for (int ch = 0; ch < c; ch++) {
        float acc = 0.0f;
        for (int k = 0; k < cnt; k++) acc += w[k] * row[(s + k) * c + ch];
        trow[ox * c + ch] = acc;
      }
    }
  }
  // vertical pass: float [sh, dw, c] -> uint8 [dh, dw, c]
  for (int oy = 0; oy < dh; oy++) {
    const int s = ys[oy], cnt = yc[oy];
    const float* w = yw.data() + size_t(oy) * ymax;
    uint8_t* drow = dst + size_t(oy) * dw * c;
    for (int x = 0; x < dw * c; x++) {
      float acc = 0.0f;
      for (int k = 0; k < cnt; k++) acc += w[k] * tmp[size_t(s + k) * dw * c + x];
      const int v = int(acc + 0.5f);
      drow[x] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// -- bilinear (half-pixel centers, cv2 INTER_LINEAR semantics) -- the policy
// pairs it with area: bilinear for mild ratios (< 2x both axes, where area's
// support collapses to bilinear's anyway), area for real decimation.

void bilinear_axis(int in_len, int out_len, std::vector<int>& lo, std::vector<float>& frac) {
  lo.resize(out_len);
  frac.resize(out_len);
  const double scale = double(in_len) / out_len;
  for (int o = 0; o < out_len; o++) {
    double f = (o + 0.5) * scale - 0.5;
    int i = int(std::floor(f));
    float w = float(f - i);
    if (i < 0) { i = 0; w = 0.0f; }
    if (i >= in_len - 1) { i = in_len >= 2 ? in_len - 2 : 0; w = in_len >= 2 ? 1.0f : 0.0f; }
    lo[o] = i;
    frac[o] = w;
  }
}

// Fixed-point separable bilinear (cv2 INTER_LINEAR arithmetic: Q11 coeffs,
// horizontal pass into Q11-scaled int32 rows, vertical blend in Q22 with
// round-half-up >> 22). Horizontal-resized source rows are cached in a 2-row
// rolling window — each source row is h-resized ONCE even though consecutive
// output rows share taps — and the vertical blend is a contiguous int32 loop
// the compiler auto-vectorizes.
constexpr int kResizeBits = 11;
constexpr int kResizeScale = 1 << kResizeBits;  // 2048, cv2's INTER_RESIZE_COEF_SCALE

void resize_bilinear(const uint8_t* src, int sw, int sh, int c, uint8_t* dst, int dw, int dh) {
  std::vector<int> xlo, ylo;
  std::vector<float> xw, yw;
  bilinear_axis(sw, dw, xlo, xw);
  bilinear_axis(sh, dh, ylo, yw);
  const int row_len = dw * c;

  std::vector<int16_t> xcoef(size_t(dw) * 2);
  for (int ox = 0; ox < dw; ox++) {
    const int w1 = int(xw[ox] * kResizeScale + 0.5f);
    xcoef[size_t(ox) * 2] = int16_t(kResizeScale - w1);
    xcoef[size_t(ox) * 2 + 1] = int16_t(w1);
  }

  // rolling cache: h-resized (Q11) versions of the two source rows feeding
  // the current output row
  std::vector<int32_t> hbuf(size_t(row_len) * 2);
  int cached[2] = {-1, -1};

  // precomputed per-output-x source offsets keep the hot loops free of the
  // min() clamp and the *c multiply
  std::vector<int> xs0(dw), xs1(dw);
  for (int ox = 0; ox < dw; ox++) {
    xs0[ox] = xlo[ox] * c;
    xs1[ox] = std::min(xlo[ox] + 1, sw - 1) * c;
  }

  auto hresize = [&](int sy, int slot) {
    const uint8_t* srow = src + size_t(sy) * sw * c;
    int32_t* out = hbuf.data() + size_t(slot) * row_len;
    if (c == 3) {  // the dominant case: unrolled channel chain
      for (int ox = 0; ox < dw; ox++) {
        const uint8_t* a = srow + xs0[ox];
        const uint8_t* b = srow + xs1[ox];
        const int w0 = xcoef[size_t(ox) * 2], w1 = xcoef[size_t(ox) * 2 + 1];
        int32_t* o = out + ox * 3;
        o[0] = w0 * a[0] + w1 * b[0];
        o[1] = w0 * a[1] + w1 * b[1];
        o[2] = w0 * a[2] + w1 * b[2];
      }
    } else {
      for (int ox = 0; ox < dw; ox++) {
        const uint8_t* a = srow + xs0[ox];
        const uint8_t* b = srow + xs1[ox];
        const int w0 = xcoef[size_t(ox) * 2], w1 = xcoef[size_t(ox) * 2 + 1];
        for (int ch = 0; ch < c; ch++) {
          out[ox * c + ch] = w0 * a[ch] + w1 * b[ch];
        }
      }
    }
    cached[slot] = sy;
  };

  for (int oy = 0; oy < dh; oy++) {
    const int y0 = ylo[oy];
    const int y1 = std::min(y0 + 1, sh - 1);
    // keep an already-resized row when the window slides by one (y0 ==
    // previous y1): move it to slot 0 by swapping the slot roles
    int slot0 = (cached[0] == y0) ? 0 : (cached[1] == y0 ? 1 : -1);
    if (slot0 < 0) {
      hresize(y0, 0);
      slot0 = 0;
    }
    const int other = 1 - slot0;
    int slot1 = (y1 == y0) ? slot0 : ((cached[other] == y1) ? other : -1);
    if (slot1 < 0) {
      hresize(y1, other);
      slot1 = other;
    }
    const int32_t* r0 = hbuf.data() + size_t(slot0) * row_len;
    const int32_t* r1 = hbuf.data() + size_t(slot1) * row_len;
    const int w1 = int(yw[oy] * kResizeScale + 0.5f);
    const int w0 = kResizeScale - w1;
    uint8_t* drow = dst + size_t(oy) * dw * c;
    constexpr int kRound = 1 << (2 * kResizeBits - 1);
    for (int i = 0; i < row_len; i++) {
      // Q11*Q11 = Q22; max 2048*2048*255 < 2^31 — no overflow
      const int32_t v = (w0 * r0[i] + w1 * r1[i] + kRound) >> (2 * kResizeBits);
      drow[i] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// mirror of the python-side policy (codecs._mild_ratio): keep in sync.
// Mixed down+up shapes use bilinear (area needs decimation on both axes).
bool mild_ratio(int in_h, int in_w, int out_h, int out_w) {
  if (out_h > in_h || out_w > in_w) return true;
  return in_h < 2 * out_h && in_w < 2 * out_w;
}

int decode_resize_one(const uint8_t* data, uint64_t len, const int32_t* info, uint8_t* out,
                      std::string* err, int min_w, int min_h, int out_w, int out_h) {
  try {
    const int sw = info[0], sh = info[1], c = info[2];
    if (info[3] != 8) {
      *err = "fused resize supports 8-bit images only";
      return -1;
    }
    if (sw == out_w && sh == out_h) {
      return decode_one(data, len, info, out, err, min_w, min_h);
    }
    std::vector<uint8_t> scratch(size_t(sw) * sh * c);
    if (decode_one(data, len, info, scratch.data(), err, min_w, min_h) != 0) return -1;
    if (mild_ratio(sh, sw, out_h, out_w)) {
      resize_bilinear(scratch.data(), sw, sh, c, out, out_w, out_h);
    } else {
      resize_area(scratch.data(), sw, sh, c, out, out_w, out_h);
    }
    return 0;
  } catch (const std::exception& e) {
    *err = e.what();
    return -1;
  } catch (...) {
    *err = "unknown C++ exception during image decode+resize";
    return -1;
  }
}

int decode_one(const uint8_t* data, uint64_t len, const int32_t* info, uint8_t* out,
               std::string* err, int min_w, int min_h) {
  // C++ exceptions (bad_alloc from the scratch vectors, etc.) must not cross
  // the extern "C" boundary — that would std::terminate the worker process
  // instead of letting Python fall back to the per-image path.
  try {
    if (len >= 8 && std::memcmp(data, kPngMagic, 8) == 0) {
      const int rc = decode_png_fast(data, len, info, out, err);
      if (rc != 0) return rc == 1 ? 0 : -1;
      return decode_png(data, len, info, out, err);
    }
    return decode_jpeg(data, len, info, out, err, min_w, min_h);
  } catch (const std::exception& e) {
    *err = e.what();
    return -1;
  } catch (...) {
    *err = "unknown C++ exception during image decode";
    return -1;
  }
}

// Shared fan-out scaffolding for the batch entry points: run fn(i, &err) for
// every index, inline when threads <= 1, else over an internal pool with
// first-failure reporting. Returns -1 on success, else the lowest failed index
// (g_error carries its message).
template <typename Fn>
int64_t run_batch(int64_t n, int threads, Fn&& fn) {
  if (n <= 0) return -1;
  if (threads <= 1 || n == 1) {
    for (int64_t i = 0; i < n; i++) {
      std::string err;
      if (fn(i, &err) != 0) {
        g_error = err;
        return i;
      }
    }
    return -1;
  }
  const int nt = int(std::min<int64_t>(threads, n));
  std::atomic<int64_t> next{0};
  std::atomic<bool> any_fail{false};
  std::mutex fail_mutex;
  int64_t fail_idx = -1;
  std::string fail_err;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  try {
    for (int t = 0; t < nt; t++) {
      pool.emplace_back([&]() {
        for (;;) {
          const int64_t i = next.fetch_add(1, std::memory_order_relaxed);
          if (i >= n) return;
          if (any_fail.load(std::memory_order_relaxed)) return;  // stop early
          std::string err;
          if (fn(i, &err) != 0) {
            any_fail.store(true, std::memory_order_relaxed);
            std::lock_guard<std::mutex> lock(fail_mutex);
            if (fail_idx < 0 || i < fail_idx) {
              fail_idx = i;
              fail_err = err;
            }
          }
        }
      });
    }
  } catch (...) {  // thread spawn failed: join what started, run inline
    for (auto& th : pool) th.join();
    for (int64_t i = 0; i < n; i++) {
      std::string err;
      if (fn(i, &err) != 0) {
        g_error = err;
        return i;
      }
    }
    return -1;
  }
  for (auto& th : pool) th.join();
  if (fail_idx >= 0) {
    g_error = fail_err.empty() ? "image decode failed" : fail_err;
    return fail_idx;
  }
  return -1;
}

}  // namespace

extern "C" {

const char* pstpu_img_last_error() { return g_error.c_str(); }

// What this build decodes with: bit 0 libjpeg, bit 1 libpng, bit 2 libdeflate
// (clear: the PNG fast path inflates with zlib).
int32_t pstpu_img_features() {
  return (PSTPU_HAVE_JPEG ? 1 : 0) | (PSTPU_HAVE_PNG ? 2 : 0) | (PSTPU_HAVE_DEFLATE ? 4 : 0);
}

// Probe n images; infos is n*4 int32 [w,h,c,bit_depth]. Returns -1 when all
// probed fine, else the index of the first unsupported/corrupt image
// (pstpu_img_last_error says why).
// min_w/min_h > 0 turn on scaled JPEG decode: reported dims are the smallest
// m/8 DCT scale still covering (min_w, min_h); PNG dims are unaffected.
int64_t pstpu_img_probe_batch2(int64_t n, const uint8_t* const* datas, const uint64_t* lens,
                               int32_t* infos, int32_t min_w, int32_t min_h) {
  g_error.clear();
  for (int64_t i = 0; i < n; i++) {
    if (probe_one(datas[i], lens[i], infos + i * 4, min_w, min_h) != 0) {
      if (g_error.empty()) g_error = "unsupported or corrupt image";
      return i;
    }
  }
  return -1;
}

// Decode n images into caller-allocated buffers (outs[i] sized from infos).
// `threads` <= 1 decodes inline on the calling thread (callers inside a reader
// worker pool want this — the pool already parallelizes across row groups);
// higher values fan out across an internal thread pool. min_w/min_h must match
// the probe call that sized the outputs. Returns -1 on success, else the index
// of the first failure (pstpu_img_last_error has the message).
int64_t pstpu_img_decode_batch2(int64_t n, const uint8_t* const* datas, const uint64_t* lens,
                                uint8_t* const* outs, const int32_t* infos, int threads,
                                int32_t min_w, int32_t min_h) {
  return run_batch(n, threads, [&](int64_t i, std::string* err) {
    return decode_one(datas[i], lens[i], infos + i * 4, outs[i], err, min_w, min_h);
  });
}

// Standalone area resample of one decoded 8-bit image (OpenCV-less
// deployments use this where cv2.resize would run). Returns 0, or -1 on
// invalid dims.
int64_t pstpu_img_resize_area(const uint8_t* src, int32_t sw, int32_t sh, int32_t c,
                              uint8_t* dst, int32_t dw, int32_t dh) {
  if (sw < 1 || sh < 1 || dw < 1 || dh < 1 || c < 1) return -1;
  try {
    resize_area(src, sw, sh, c, dst, dw, dh);
    return 0;
  } catch (...) {
    g_error = "resize failed";
    return -1;
  }
}

// Standalone bilinear resample (half-pixel centers; the mild-ratio half of
// the shared resize policy).
int64_t pstpu_img_resize_bilinear(const uint8_t* src, int32_t sw, int32_t sh, int32_t c,
                                  uint8_t* dst, int32_t dw, int32_t dh) {
  if (sw < 1 || sh < 1 || dw < 1 || dh < 1 || c < 1) return -1;
  try {
    resize_bilinear(src, sw, sh, c, dst, dw, dh);
    return 0;
  } catch (...) {
    g_error = "resize failed";
    return -1;
  }
}

// Fused decode+resize: each image is decoded at its probed dims (JPEG: the
// min_w/min_h DCT scale, matching the probe) then resampled — bilinear for
// mild ratios, area for >= 2x decimation (the shared policy) — into its
// caller-allocated out_h x out_w output — one GIL-released call replaces the
// per-row Python resize transform. 8-bit images only.
int64_t pstpu_img_decode_resize_batch(int64_t n, const uint8_t* const* datas,
                                      const uint64_t* lens, uint8_t* const* outs,
                                      const int32_t* infos, int threads,
                                      int32_t min_w, int32_t min_h,
                                      int32_t out_w, int32_t out_h) {
  return run_batch(n, threads, [&](int64_t i, std::string* err) {
    return decode_resize_one(datas[i], lens[i], infos + i * 4, outs[i], err,
                             min_w, min_h, out_w, out_h);
  });
}

}  // extern "C"
