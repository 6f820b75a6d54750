// Native host-IO runtime for the TPU stereo engine.
//
// The reference (SURVEY.md §1 L0, [K-high]) does host-side image IO in
// Python (cv2/PIL) — its ancestral C implementation (SURVEY.md §0,
// Revaud's deepmatching 1.2.2) did this layer in C.  This module is the
// framework's native equivalent: the parts of the pipeline OUTSIDE the
// XLA program (decode, grayscale+normalize+pad prologue, encode, and a
// threaded prefetching pair-loader that overlaps host decode with TPU
// compute) implemented in C++ and exposed through a plain C ABI for
// ctypes (no pybind11 in this environment).
//
// Codecs:
//   * PGM/PPM (P5/P6, 8- and 16-bit)      read + write
//   * PFM (Middlebury float, grayscale)   read + write
//   * PNG (gray 8/16-bit, RGB 8-bit)      write, via zlib (stored in the
//     repo toolchain; CRC32 + deflate from libz, filter type 0)
//
// Error handling: every entry point returns 0 on success / negative on
// failure and records a message retrievable via dms_last_error() (thread
// local, so the loader workers don't race on it).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#define DMS_API extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_error;

int fail(const std::string& msg) {
  g_error = msg;
  return -1;
}

struct File {
  FILE* f = nullptr;
  explicit File(const char* path, const char* mode)
      : f(std::fopen(path, mode)) {}
  ~File() {
    if (f) std::fclose(f);
  }
  explicit operator bool() const { return f != nullptr; }
};

// ---------------------------------------------------------------------
// PNM (PGM P5 / PPM P6)
// ---------------------------------------------------------------------

// Read one whitespace/comment-delimited ASCII token from a PNM header.
bool pnm_token(FILE* f, std::string* tok) {
  tok->clear();
  int c;
  for (;;) {
    c = std::fgetc(f);
    if (c == EOF) return false;
    if (c == '#') {  // comment to end of line
      while (c != EOF && c != '\n') c = std::fgetc(f);
      continue;
    }
    if (!std::isspace(c)) break;
  }
  for (; c != EOF && !std::isspace(c); c = std::fgetc(f)) {
    tok->push_back(static_cast<char>(c));
  }
  return !tok->empty();
}

}  // namespace

DMS_API const char* dms_last_error() { return g_error.c_str(); }

DMS_API void dms_free(void* p) { std::free(p); }

// Decode P5/P6. *data is malloc'd (u8, or u16 native-endian when
// *maxval > 255); layout (h, w, channels) row-major. Caller frees.
DMS_API int dms_read_pnm(const char* path, void** data, int* w, int* h,
                         int* channels, int* maxval) {
  File file(path, "rb");
  if (!file) return fail(std::string("open failed: ") + path);
  std::string tok;
  if (!pnm_token(file.f, &tok)) return fail("truncated PNM header");
  int ch;
  if (tok == "P5") {
    ch = 1;
  } else if (tok == "P6") {
    ch = 3;
  } else {
    return fail("unsupported PNM magic '" + tok + "'");
  }
  long vals[3];
  for (int i = 0; i < 3; ++i) {
    if (!pnm_token(file.f, &tok)) return fail("truncated PNM header");
    char* end = nullptr;
    errno = 0;
    vals[i] = std::strtol(tok.c_str(), &end, 10);
    if (errno != 0 || end == tok.c_str() || *end != '\0' || vals[i] <= 0) {
      return fail("bad PNM header value '" + tok + "'");
    }
  }
  const long W = vals[0], H = vals[1], MAXV = vals[2];
  if (MAXV > 65535) return fail("PNM maxval > 65535");
  // Dimension caps: reject absurd headers before the W*H*ch
  // multiplication can overflow or a hostile file can demand the
  // machine's RAM (1 << 30 pixels = 4 GiB of u8 RGB).
  if (W > (1L << 20) || H > (1L << 20) || W * H > (1L << 30)) {
    return fail("PNM dimensions out of range");
  }
  const int bytes_per = MAXV > 255 ? 2 : 1;
  const size_t count = static_cast<size_t>(W) * H * ch;
  void* buf = std::malloc(count * bytes_per);
  if (!buf) return fail("out of memory");
  if (std::fread(buf, bytes_per, count, file.f) != count) {
    std::free(buf);
    return fail("truncated PNM pixel data");
  }
  if (bytes_per == 2) {  // PNM 16-bit is big-endian on disk
    auto* p = static_cast<uint16_t*>(buf);
    for (size_t i = 0; i < count; ++i) {
      p[i] = static_cast<uint16_t>((p[i] >> 8) | (p[i] << 8));
    }
  }
  *data = buf;
  *w = static_cast<int>(W);
  *h = static_cast<int>(H);
  *channels = ch;
  *maxval = static_cast<int>(MAXV);
  return 0;
}

DMS_API int dms_write_pnm(const char* path, const void* data, int w, int h,
                          int channels, int maxval) {
  if (channels != 1 && channels != 3) return fail("channels must be 1 or 3");
  File file(path, "wb");
  if (!file) return fail(std::string("open failed: ") + path);
  std::fprintf(file.f, "%s\n%d %d\n%d\n", channels == 1 ? "P5" : "P6", w, h,
               maxval);
  const size_t count = static_cast<size_t>(w) * h * channels;
  if (maxval > 255) {
    std::vector<uint16_t> be(count);
    const auto* src = static_cast<const uint16_t*>(data);
    for (size_t i = 0; i < count; ++i) {
      be[i] = static_cast<uint16_t>((src[i] >> 8) | (src[i] << 8));
    }
    if (std::fwrite(be.data(), 2, count, file.f) != count) {
      return fail("short write");
    }
  } else if (std::fwrite(data, 1, count, file.f) != count) {
    return fail("short write");
  }
  return 0;
}

// ---------------------------------------------------------------------
// PFM (Middlebury float map; negative scale = little-endian)
// ---------------------------------------------------------------------

DMS_API int dms_read_pfm(const char* path, float** data, int* w, int* h) {
  File file(path, "rb");
  if (!file) return fail(std::string("open failed: ") + path);
  std::string tok;
  if (!pnm_token(file.f, &tok) || tok != "Pf") {
    return fail("not a grayscale PFM (magic 'Pf')");
  }
  std::string ws, hs, ss;
  if (!pnm_token(file.f, &ws) || !pnm_token(file.f, &hs) ||
      !pnm_token(file.f, &ss)) {
    return fail("truncated PFM header");
  }
  const long W = std::strtol(ws.c_str(), nullptr, 10);
  const long H = std::strtol(hs.c_str(), nullptr, 10);
  const double scale = std::strtod(ss.c_str(), nullptr);
  if (W <= 0 || H <= 0) return fail("bad PFM dimensions");
  const size_t count = static_cast<size_t>(W) * H;
  auto* buf = static_cast<float*>(std::malloc(count * sizeof(float)));
  if (!buf) return fail("out of memory");
  // PFM rows are stored bottom-up; return top-down.
  for (long r = 0; r < H; ++r) {
    float* row = buf + (H - 1 - r) * W;
    if (std::fread(row, sizeof(float), W, file.f) !=
        static_cast<size_t>(W)) {
      std::free(buf);
      return fail("truncated PFM pixel data");
    }
  }
  if (scale > 0) {  // big-endian on disk
    auto* p = reinterpret_cast<uint32_t*>(buf);
    for (size_t i = 0; i < count; ++i) p[i] = __builtin_bswap32(p[i]);
  }
  *data = buf;
  *w = static_cast<int>(W);
  *h = static_cast<int>(H);
  return 0;
}

DMS_API int dms_write_pfm(const char* path, const float* data, int w,
                          int h) {
  File file(path, "wb");
  if (!file) return fail(std::string("open failed: ") + path);
  std::fprintf(file.f, "Pf\n%d %d\n-1.0\n", w, h);  // little-endian
  for (int r = h - 1; r >= 0; --r) {                // bottom-up rows
    if (std::fwrite(data + static_cast<size_t>(r) * w, sizeof(float), w,
                    file.f) != static_cast<size_t>(w)) {
      return fail("short write");
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// PNG writer (zlib deflate, filter 0). Gray 8/16-bit, RGB 8-bit.
// ---------------------------------------------------------------------

namespace {

void png_chunk(FILE* f, const char type[4], const uint8_t* payload,
               uint32_t len) {
  uint8_t hdr[8] = {
      static_cast<uint8_t>(len >> 24), static_cast<uint8_t>(len >> 16),
      static_cast<uint8_t>(len >> 8),  static_cast<uint8_t>(len),
      static_cast<uint8_t>(type[0]),   static_cast<uint8_t>(type[1]),
      static_cast<uint8_t>(type[2]),   static_cast<uint8_t>(type[3])};
  std::fwrite(hdr, 1, 8, f);
  if (len) std::fwrite(payload, 1, len, f);
  uLong crc = crc32(0L, hdr + 4, 4);
  // zlib quirk: crc32(crc, Z_NULL, 0) RESETS to the initial value
  // instead of returning crc, which used to corrupt the (empty) IEND
  // chunk's CRC and made strict decoders reject every file.
  if (len) crc = crc32(crc, payload, len);
  uint8_t tail[4] = {
      static_cast<uint8_t>(crc >> 24), static_cast<uint8_t>(crc >> 16),
      static_cast<uint8_t>(crc >> 8), static_cast<uint8_t>(crc)};
  std::fwrite(tail, 1, 4, f);
}

}  // namespace

// data: u8 (bitdepth 8) or native-endian u16 (bitdepth 16, gray only),
// (h, w, channels) row-major.
DMS_API int dms_write_png(const char* path, const void* data, int w, int h,
                          int channels, int bitdepth) {
  if ((channels != 1 && channels != 3) ||
      (bitdepth != 8 && bitdepth != 16) || (bitdepth == 16 && channels != 1)) {
    return fail("unsupported PNG layout (gray 8/16 or RGB 8 only)");
  }
  const size_t row_bytes = static_cast<size_t>(w) * channels * (bitdepth / 8);
  // Filtered scanlines: one filter-type byte (0) per row.
  std::vector<uint8_t> raw((row_bytes + 1) * h);
  for (int r = 0; r < h; ++r) {
    uint8_t* dst = raw.data() + static_cast<size_t>(r) * (row_bytes + 1);
    *dst++ = 0;
    if (bitdepth == 16) {  // PNG samples are big-endian
      const auto* src = static_cast<const uint16_t*>(data) +
                        static_cast<size_t>(r) * w;
      for (int c = 0; c < w; ++c) {
        dst[2 * c] = static_cast<uint8_t>(src[c] >> 8);
        dst[2 * c + 1] = static_cast<uint8_t>(src[c]);
      }
    } else {
      std::memcpy(dst,
                  static_cast<const uint8_t*>(data) +
                      static_cast<size_t>(r) * row_bytes,
                  row_bytes);
    }
  }
  uLongf zlen = compressBound(raw.size());
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), raw.size(), 6) != Z_OK) {
    return fail("zlib compress2 failed");
  }

  File file(path, "wb");
  if (!file) return fail(std::string("open failed: ") + path);
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::fwrite(sig, 1, 8, file.f);
  const uint8_t color_type = channels == 3 ? 2 : 0;
  uint8_t ihdr[13] = {static_cast<uint8_t>(w >> 24),
                      static_cast<uint8_t>(w >> 16),
                      static_cast<uint8_t>(w >> 8),
                      static_cast<uint8_t>(w),
                      static_cast<uint8_t>(h >> 24),
                      static_cast<uint8_t>(h >> 16),
                      static_cast<uint8_t>(h >> 8),
                      static_cast<uint8_t>(h),
                      static_cast<uint8_t>(bitdepth),
                      color_type,
                      0,
                      0,
                      0};
  png_chunk(file.f, "IHDR", ihdr, 13);
  png_chunk(file.f, "IDAT", z.data(), static_cast<uint32_t>(zlen));
  png_chunk(file.f, "IEND", nullptr, 0);
  if (std::ferror(file.f)) return fail("short write");
  return 0;
}

// ---------------------------------------------------------------------
// PNG reader (zlib inflate + per-row unfilter).  Gray 8/16, RGB 8/16,
// RGBA 8 (alpha dropped -> RGB).  Non-interlaced, non-palette only —
// the Middlebury/KITTI dataset files this loader exists for
// (BASELINE.json:7,9) are plain 8-bit RGB and 16-bit gray PNGs.
// ---------------------------------------------------------------------

namespace {

uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// PNG Paeth predictor (RFC 2083 §6.6).
uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// Decode a PNG.  *data is malloc'd: u8, or native-endian u16 when
// *bitdepth == 16; layout (h, w, channels) row-major; RGBA input is
// returned as RGB (alpha dropped).  Caller frees with dms_free.
DMS_API int dms_read_png(const char* path, void** data, int* w, int* h,
                         int* channels, int* bitdepth) {
  File file(path, "rb");
  if (!file) return fail(std::string("open failed: ") + path);
  uint8_t sig[8];
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                  '\n'};
  if (std::fread(sig, 1, 8, file.f) != 8 || std::memcmp(sig, kSig, 8)) {
    return fail("not a PNG file");
  }
  long W = 0, H = 0;
  int depth = 0, color = -1, in_ch = 0;
  std::vector<uint8_t> idat;
  bool seen_iend = false;
  while (!seen_iend) {
    uint8_t hdr[8];
    if (std::fread(hdr, 1, 8, file.f) != 8) return fail("truncated PNG");
    const uint32_t len = be32(hdr);
    if (len > (1u << 30)) return fail("PNG chunk too large");
    const char* type = reinterpret_cast<const char*>(hdr + 4);
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return fail("bad IHDR");
      uint8_t ih[13];
      if (std::fread(ih, 1, 13, file.f) != 13) return fail("bad IHDR");
      W = be32(ih);
      H = be32(ih + 4);
      depth = ih[8];
      color = ih[9];
      if (ih[12] != 0) return fail("interlaced PNG unsupported");
      if (W <= 0 || H <= 0 || W > (1L << 20) || H > (1L << 20) ||
          W * H > (1L << 30)) {
        return fail("PNG dimensions out of range");
      }
      switch (color) {
        case 0: in_ch = 1; break;          // gray
        case 2: in_ch = 3; break;          // RGB
        case 6: in_ch = 4; break;          // RGBA
        default:
          return fail("unsupported PNG color type (palette?)");
      }
      if (depth != 8 && depth != 16) {
        return fail("unsupported PNG bit depth");
      }
    } else if (!std::memcmp(type, "IDAT", 4)) {
      const size_t off = idat.size();
      idat.resize(off + len);
      if (std::fread(idat.data() + off, 1, len, file.f) != len) {
        return fail("truncated IDAT");
      }
    } else if (!std::memcmp(type, "IEND", 4)) {
      seen_iend = true;
      if (len && std::fseek(file.f, len, SEEK_CUR)) return fail("bad IEND");
    } else {  // ancillary chunk: skip payload
      if (std::fseek(file.f, len, SEEK_CUR)) return fail("truncated PNG");
    }
    if (std::fseek(file.f, 4, SEEK_CUR)) {  // chunk CRC (not verified)
      return fail("truncated PNG");
    }
  }
  if (!W || idat.empty()) return fail("PNG missing IHDR/IDAT");

  const size_t bpp = static_cast<size_t>(in_ch) * (depth / 8);
  const size_t row_bytes = static_cast<size_t>(W) * bpp;
  std::vector<uint8_t> raw((row_bytes + 1) * H);
  uLongf rawlen = raw.size();
  const int zrc = uncompress(raw.data(), &rawlen, idat.data(),
                             static_cast<uLong>(idat.size()));
  if (zrc != Z_OK || rawlen != raw.size()) {
    return fail("PNG inflate failed");
  }
  // Unfilter in place (scanline filters operate on raw bytes).
  std::vector<uint8_t> prev(row_bytes, 0);
  for (long r = 0; r < H; ++r) {
    uint8_t* line = raw.data() + static_cast<size_t>(r) * (row_bytes + 1);
    const uint8_t ft = line[0];
    uint8_t* cur = line + 1;
    switch (ft) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < row_bytes; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:  // Up
        for (size_t i = 0; i < row_bytes; ++i) cur[i] += prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < bpp; ++i) cur[i] += prev[i] / 2;
        for (size_t i = bpp; i < row_bytes; ++i) {
          cur[i] += static_cast<uint8_t>((cur[i - bpp] + prev[i]) / 2);
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < bpp; ++i) cur[i] += paeth(0, prev[i], 0);
        for (size_t i = bpp; i < row_bytes; ++i) {
          cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
        }
        break;
      default:
        return fail("bad PNG filter type");
    }
    std::memcpy(prev.data(), cur, row_bytes);
  }
  // Emit (h, w, out_ch), dropping alpha, fixing 16-bit endianness.
  const int out_ch = in_ch == 4 ? 3 : in_ch;
  const size_t count = static_cast<size_t>(W) * H * out_ch;
  const int bytes_per = depth / 8;
  void* buf = std::malloc(count * bytes_per);
  if (!buf) return fail("out of memory");
  for (long r = 0; r < H; ++r) {
    const uint8_t* src =
        raw.data() + static_cast<size_t>(r) * (row_bytes + 1) + 1;
    if (depth == 8) {
      auto* dst = static_cast<uint8_t*>(buf) +
                  static_cast<size_t>(r) * W * out_ch;
      if (in_ch == out_ch) {
        std::memcpy(dst, src, row_bytes);
      } else {  // RGBA -> RGB
        for (long c = 0; c < W; ++c) {
          dst[3 * c] = src[4 * c];
          dst[3 * c + 1] = src[4 * c + 1];
          dst[3 * c + 2] = src[4 * c + 2];
        }
      }
    } else {  // 16-bit big-endian samples -> native u16
      auto* dst = static_cast<uint16_t*>(buf) +
                  static_cast<size_t>(r) * W * out_ch;
      for (long c = 0; c < W * in_ch; ++c) {
        const long oc = in_ch == 4 ? (c / 4) * 3 + (c % 4) : c;
        if (in_ch == 4 && c % 4 == 3) continue;
        dst[oc] = static_cast<uint16_t>((src[2 * c] << 8) | src[2 * c + 1]);
      }
    }
  }
  *data = buf;
  *w = static_cast<int>(W);
  *h = static_cast<int>(H);
  *channels = out_ch;
  *bitdepth = depth;
  return 0;
}

// Sniff the magic and decode PNM or PNG.  *maxval is 255/65535 for
// PNG (by bit depth) or the PNM header value.
DMS_API int dms_read_image(const char* path, void** data, int* w, int* h,
                           int* channels, int* maxval) {
  uint8_t magic[2] = {0, 0};
  {
    File probe(path, "rb");
    if (!probe) return fail(std::string("open failed: ") + path);
    if (std::fread(magic, 1, 2, probe.f) != 2) {
      return fail("file too short");
    }
  }
  if (magic[0] == 'P' && (magic[1] == '5' || magic[1] == '6')) {
    return dms_read_pnm(path, data, w, h, channels, maxval);
  }
  if (magic[0] == 0x89 && magic[1] == 'P') {
    int depth = 0;
    const int rc = dms_read_png(path, data, w, h, channels, &depth);
    if (rc == 0) *maxval = depth == 16 ? 65535 : 255;
    return rc;
  }
  return fail("unsupported image format (PNM/PNG only)");
}

// ---------------------------------------------------------------------
// Host prologue: grayscale + normalize + zero-pad, one pass.
// Matches oracle/reference.py:to_grayscale_f32 + pad_image exactly:
// BT.601 weights for RGB, /255 for integer inputs, zero pad
// bottom/right to (ph, pw).  dst: caller-provided float32 (ph, pw).
// ---------------------------------------------------------------------

DMS_API int dms_gray_norm_pad(const void* src, int w, int h, int channels,
                              int is_u16, int pw, int ph, float* dst) {
  if (w > pw || h > ph) return fail("padded size smaller than image");
  if (channels != 1 && channels != 3) return fail("channels must be 1 or 3");
  // Pass 1: grayscale into dst (unnormalised), tracking the max.
  float maxv = 0.0f;
  for (int r = 0; r < ph; ++r) {
    float* out = dst + static_cast<size_t>(r) * pw;
    if (r >= h) {
      std::memset(out, 0, sizeof(float) * pw);
      continue;
    }
    if (channels == 1) {
      if (is_u16) {
        const auto* p = static_cast<const uint16_t*>(src) +
                        static_cast<size_t>(r) * w;
        for (int c = 0; c < w; ++c) out[c] = static_cast<float>(p[c]);
      } else {
        const auto* p = static_cast<const uint8_t*>(src) +
                        static_cast<size_t>(r) * w;
        for (int c = 0; c < w; ++c) out[c] = static_cast<float>(p[c]);
      }
    } else {
      // Match the oracle's explicit left-to-right f32 sum (built with
      // -ffp-contract=off so no FMA changes the rounding).
      if (is_u16) {
        const auto* p = static_cast<const uint16_t*>(src) +
                        static_cast<size_t>(r) * w * 3;
        for (int c = 0; c < w; ++c) {
          out[c] = 0.299f * p[3 * c] + 0.587f * p[3 * c + 1] +
                   0.114f * p[3 * c + 2];
        }
      } else {
        const auto* p = static_cast<const uint8_t*>(src) +
                        static_cast<size_t>(r) * w * 3;
        for (int c = 0; c < w; ++c) {
          out[c] = 0.299f * p[3 * c] + 0.587f * p[3 * c + 1] +
                   0.114f * p[3 * c + 2];
        }
      }
    }
    for (int c = 0; c < w; ++c) maxv = out[c] > maxv ? out[c] : maxv;
    for (int c = w; c < pw; ++c) out[c] = 0.0f;
  }
  // Pass 2: the oracle's range heuristic (reference.py:to_grayscale_f32):
  // divide by 255 ONLY when the image looks 8-bit-ranged (max > 1.5);
  // already-[0,1] floats — and all-dark integer images — pass through.
  // True division, not reciprocal-multiply: x * (1/255.f) is 1 ulp off
  // numpy's `/ 255.0` on some values and breaks bit-compat.
  if (maxv > 1.5f) {
    for (int r = 0; r < h; ++r) {
      float* out = dst + static_cast<size_t>(r) * pw;
      for (int c = 0; c < w; ++c) out[c] = out[c] / 255.0f;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// Threaded prefetch loader: decode + gray_norm_pad off the main thread,
// results delivered in submission order (the TPU stream consumes batches
// in order; SURVEY.md §5.3).  Each slot: one rectified PAIR -> two
// padded float32 planes.
// ---------------------------------------------------------------------

namespace {

struct LoaderSlot {
  std::vector<float> left, right;
  bool ready = false;
  bool failed = false;
  std::string error;
};

struct Loader {
  std::vector<std::string> lefts, rights;
  int pw = 0, ph = 0;
  int max_inflight = 0;  // decoded-but-unconsumed slot budget
  std::vector<LoaderSlot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;        // consumer waits for slot ready
  std::condition_variable cv_space;  // workers wait for prefetch budget
  std::atomic<int> next_job{0};
  int next_out = 0;  // guarded by mu (workers read it for backpressure)
  std::atomic<bool> stop{false};

  int load_one(const std::string& path, std::vector<float>* out) {
    void* data = nullptr;
    int w, h, ch, maxval;
    if (dms_read_image(path.c_str(), &data, &w, &h, &ch, &maxval) != 0) {
      return -1;
    }
    out->resize(static_cast<size_t>(pw) * ph);
    const int rc = dms_gray_norm_pad(data, w, h, ch, maxval > 255 ? 1 : 0,
                                     pw, ph, out->data());
    std::free(data);
    return rc;
  }

  void worker() {
    for (;;) {
      const int i = next_job.fetch_add(1);
      if (i >= static_cast<int>(lefts.size()) || stop.load()) return;
      {
        // Backpressure: never hold more than max_inflight decoded,
        // unconsumed pairs — a long stream's RAM stays bounded at
        // max_inflight * 2 * pw * ph floats instead of growing with n.
        std::unique_lock<std::mutex> lock(mu);
        cv_space.wait(lock, [&] {
          return stop.load() || i < next_out + max_inflight;
        });
        if (stop.load()) return;
      }
      LoaderSlot local;
      if (load_one(lefts[i], &local.left) != 0 ||
          load_one(rights[i], &local.right) != 0) {
        local.failed = true;
        local.error = g_error;  // thread-local, set by the failing call
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        slots[i] = std::move(local);
        slots[i].ready = true;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

DMS_API void* dms_loader_create(const char** left_paths,
                                const char** right_paths, int n,
                                int n_threads, int pw, int ph) {
  auto* ld = new Loader;
  ld->pw = pw;
  ld->ph = ph;
  ld->max_inflight = std::max(2, 2 * n_threads);
  ld->lefts.reserve(n);
  ld->rights.reserve(n);
  for (int i = 0; i < n; ++i) {
    ld->lefts.emplace_back(left_paths[i]);
    ld->rights.emplace_back(right_paths[i]);
  }
  ld->slots.resize(n);
  const int nt = std::max(1, std::min(n_threads, n > 0 ? n : 1));
  for (int t = 0; t < nt; ++t) {
    ld->workers.emplace_back(&Loader::worker, ld);
  }
  return ld;
}

// Copies the next pair (in submission order) into dst_left/dst_right,
// each float32 (ph, pw).  Returns the pair index, -1 when exhausted,
// -2 on decode failure (message via dms_last_error()).
DMS_API int dms_loader_next(void* handle, float* dst_left,
                            float* dst_right) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(ld->mu);
  if (ld->next_out >= static_cast<int>(ld->slots.size())) return -1;
  const int i = ld->next_out++;
  ld->cv_space.notify_all();  // budget freed for the prefetch workers
  ld->cv.wait(lock, [&] { return ld->slots[i].ready; });
  LoaderSlot& s = ld->slots[i];
  if (s.failed) {
    g_error = s.error;
    return -2;
  }
  std::memcpy(dst_left, s.left.data(), s.left.size() * sizeof(float));
  std::memcpy(dst_right, s.right.data(), s.right.size() * sizeof(float));
  // Release the decoded planes eagerly; the slot stays "ready".
  s.left.clear();
  s.left.shrink_to_fit();
  s.right.clear();
  s.right.shrink_to_fit();
  return i;
}

DMS_API void dms_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  ld->stop.store(true);
  {
    std::lock_guard<std::mutex> lock(ld->mu);  // wake backpressure waits
  }
  ld->cv_space.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}
