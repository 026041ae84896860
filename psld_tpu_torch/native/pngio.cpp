// Native batch PNG codec of the port (a copy of the JAX package's
// psld_tpu/native/pngio.cpp): multithreaded encoding of sample batches and
// decoding of image-folder datasets, on the host.
//
// Writer: IHDR + one IDAT (zlib deflate, filter 0 on every row) + IEND.
// Reader: 8-bit, non-interlaced gray, gray+alpha, RGB, RGBA and palette
// PNGs (any filter; palette expanded to RGB), each checked against the
// shape the caller names (-6 on another); 16-bit, interlaced and
// transparency-chunk files return -5 (unsupported). Links
// against the system zlib. Built at first use by
// psld_tpu_torch/native/__init__.py.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

namespace {

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

// Write one chunk: length, type, payload, crc.
bool write_chunk(FILE* f, const char type[4], const uint8_t* payload,
                 uint32_t len) {
  uint8_t hdr[8];
  put_be32(hdr, len);
  memcpy(hdr + 4, type, 4);
  if (fwrite(hdr, 1, 8, f) != 8) return false;
  if (len && fwrite(payload, 1, len, f) != len) return false;
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, reinterpret_cast<const Bytef*>(type), 4);
  if (len) crc = crc32(crc, payload, len);
  uint8_t crcb[4];
  put_be32(crcb, crc);
  return fwrite(crcb, 1, 4, f) == 4;
}

int encode_one(const char* path, const uint8_t* img, int h, int w, int c) {
  if (c != 1 && c != 3 && c != 4) return -2;
  const size_t row = static_cast<size_t>(w) * c;
  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw((row + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (row + 1)] = 0;
    memcpy(&raw[y * (row + 1) + 1], img + y * row, row);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 1) != Z_OK)
    return -3;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  bool ok = fwrite(magic, 1, 8, f) == 8;

  uint8_t ihdr[13];
  put_be32(ihdr, static_cast<uint32_t>(w));
  put_be32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;                                   // bit depth
  ihdr[9] = (c == 1) ? 0 : (c == 3 ? 2 : 6);     // gray / rgb / rgba
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  ok = ok && write_chunk(f, "IHDR", ihdr, 13);
  ok = ok && write_chunk(f, "IDAT", comp.data(), comp_cap);
  ok = ok && write_chunk(f, "IEND", nullptr, 0);
  fclose(f);
  return ok ? 0 : -4;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngInfo {
  uint32_t w = 0, h = 0;
  int color_type = -1;   // 0 gray, 2 rgb, 3 palette, 4 gray+a, 6 rgba
  int src_ch = 0;        // bytes/pixel in the filtered stream
  int out_ch = 0;        // channels after palette expansion
};

// Parse chunks; returns 0 or a negative error (-5 = valid but unsupported
// PNG variant -- callers fall back to a generic decoder). info_only stops
// right after IHDR (the first chunk) so shape queries don't read the file.
int read_chunks(FILE* f, PngInfo* info, std::vector<uint8_t>* idat,
                std::vector<uint8_t>* plte, bool info_only = false) {
  uint8_t magic[8];
  static const uint8_t want[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, want, 8)) return -1;
  bool seen_ihdr = false;
  for (;;) {
    uint8_t hdr[8];
    if (fread(hdr, 1, 8, f) != 8) return -1;
    uint32_t len = be32(hdr);
    if (len > (1u << 28)) return -1;  // corrupt-header allocation guard
    char type[5] = {char(hdr[4]), char(hdr[5]), char(hdr[6]), char(hdr[7]), 0};
    std::vector<uint8_t> payload(len);
    if (len && fread(payload.data(), 1, len, f) != len) return -1;
    if (fseek(f, 4, SEEK_CUR) != 0) return -1;  // skip CRC
    if (!strcmp(type, "IHDR")) {
      if (len != 13) return -1;
      info->w = be32(payload.data());
      info->h = be32(payload.data() + 4);
      int depth = payload[8];
      info->color_type = payload[9];
      int interlace = payload[12];
      if (depth != 8 || interlace != 0) return -5;
      switch (info->color_type) {
        case 0: info->src_ch = 1; info->out_ch = 1; break;
        case 2: info->src_ch = 3; info->out_ch = 3; break;
        case 3: info->src_ch = 1; info->out_ch = 3; break;
        case 4: info->src_ch = 2; info->out_ch = 2; break;
        case 6: info->src_ch = 4; info->out_ch = 4; break;
        default: return -5;
      }
      seen_ihdr = true;
      if (info_only) return 0;
    } else if (!strcmp(type, "PLTE")) {
      *plte = std::move(payload);
    } else if (!strcmp(type, "IDAT")) {
      idat->insert(idat->end(), payload.begin(), payload.end());
    } else if (!strcmp(type, "tRNS")) {
      return -5;  // palette/gray transparency: fall back
    } else if (!strcmp(type, "IEND")) {
      break;
    }
  }
  return seen_ihdr && !idat->empty() ? 0 : -1;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

int decode_one(const char* path, uint8_t* out, int h, int w, int c) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  PngInfo info;
  std::vector<uint8_t> idat, plte;
  int rc = read_chunks(f, &info, &idat, &plte);
  fclose(f);
  if (rc != 0) return rc;
  if (int(info.h) != h || int(info.w) != w || info.out_ch != c) return -6;
  if (info.color_type == 3 && plte.size() < 3) return -1;

  const size_t row = size_t(info.w) * info.src_ch;
  std::vector<uint8_t> raw((row + 1) * info.h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return -3;

  const int bpp = info.src_ch;
  std::vector<uint8_t> prev(row, 0);
  std::vector<uint8_t> cur(row);
  for (uint32_t y = 0; y < info.h; ++y) {
    const uint8_t* src = &raw[y * (row + 1)];
    int filter = src[0];
    const uint8_t* s = src + 1;
    switch (filter) {
      case 0:
        memcpy(cur.data(), s, row);
        break;
      case 1:
        for (size_t i = 0; i < row; ++i)
          cur[i] = s[i] + (i >= size_t(bpp) ? cur[i - bpp] : 0);
        break;
      case 2:
        for (size_t i = 0; i < row; ++i) cur[i] = s[i] + prev[i];
        break;
      case 3:
        for (size_t i = 0; i < row; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          cur[i] = s[i] + uint8_t((a + prev[i]) / 2);
        }
        break;
      case 4:
        for (size_t i = 0; i < row; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int cc = i >= size_t(bpp) ? prev[i - bpp] : 0;
          cur[i] = s[i] + paeth(a, prev[i], cc);
        }
        break;
      default:
        return -3;
    }
    uint8_t* dst = out + size_t(y) * info.w * info.out_ch;
    if (info.color_type == 3) {
      for (uint32_t x = 0; x < info.w; ++x) {
        size_t p = size_t(cur[x]) * 3;
        if (p + 2 >= plte.size()) return -1;
        dst[x * 3] = plte[p];
        dst[x * 3 + 1] = plte[p + 1];
        dst[x * 3 + 2] = plte[p + 2];
      }
    } else {
      memcpy(dst, cur.data(), row);
    }
    std::swap(prev, cur);
  }
  return 0;
}

}  // namespace

extern "C" {

// Parse IHDR only (stops after the first chunk -- does not read pixel
// data); reports the decoded output shape (palette -> 3ch). Returns 0, or
// -5 for valid-but-unsupported variants (16-bit, interlaced; transparency
// is only detected at decode time), or -1 for unreadable/corrupt files,
// or -7 on internal failure.
int psld_read_png_info(const char* path, int* h, int* w, int* c) try {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  PngInfo info;
  std::vector<uint8_t> idat, plte;
  int rc = read_chunks(f, &info, &idat, &plte, /*info_only=*/true);
  fclose(f);
  if (rc != 0) return rc;
  *h = int(info.h);
  *w = int(info.w);
  *c = info.out_ch;
  return 0;
} catch (...) {
  return -7;  // never let a C++ exception cross the ctypes boundary
}

// Decode n same-shaped PNGs into a contiguous NHWC buffer with a thread
// pool. Returns 0 or the first nonzero per-image error code.
int psld_read_png_batch(const char* const* paths, uint8_t* out, int n,
                        int h, int w, int c, int threads) try {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  if (threads > n) threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  const size_t stride = static_cast<size_t>(h) * w * c;
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != 0) break;
      int rc;
      try {
        rc = decode_one(paths[i], out + stride * i, h, w, c);
      } catch (...) {
        rc = -7;  // an exception escaping a std::thread would terminate()
      }
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
} catch (...) {
  return -7;
}

// Encode n images (contiguous NHWC uint8) to paths[i] using a thread pool.
// Returns 0 on success, else the first nonzero per-image error code.
int psld_write_png_batch(const char* const* paths, const uint8_t* data,
                         int n, int h, int w, int c, int threads) try {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  if (threads > n) threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  const size_t stride = static_cast<size_t>(h) * w * c;
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc;
      try {
        rc = encode_one(paths[i], data + stride * i, h, w, c);
      } catch (...) {
        rc = -7;
      }
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
} catch (...) {
  return -7;
}

}  // extern "C"
