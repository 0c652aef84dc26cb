// Native OpenEXR scanline codec (subset) for HDR environment maps.
//
// The port's own copy of diffusionrenderer_tpu/native/src/exr_codec.cc, built
// with hdr_codec.cc into one library (diffusionrenderer_tpu_torch/io.py); it
// needs zlib.
//
//   reader — single-part scanline images, compression NONE / RLE / ZIPS /
//            ZIP, channel types HALF / FLOAT / UINT, any channel set
//            (R,G,B picked; Y replicated for grayscale), increasing or
//            decreasing line order;
//   writer — ZIP(16-line) compressed HALF R,G,B — the common layout real
//            HDRI files use, so the reader's inflate + predictor +
//            deinterleave path is exercised by round-trip tests.
//
// Unsupported (rejected with distinct error codes): tiled, deep, multi-part,
// PIZ / PXR24 / B44 / DWA compression, subsampled channels.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------- half ----
float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) & 1u;
  uint32_t exp = (uint32_t)(h >> 10) & 0x1fu;
  uint32_t mant = (uint32_t)h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (mant == 0) {
      f = sign << 31;
    } else {  // subnormal: normalize
      int e = 127 - 15 + 1;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        --e;
      }
      mant &= 0x3ffu;
      f = (sign << 31) | ((uint32_t)e << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    f = (sign << 31) | 0x7f800000u | (mant << 13);
  } else {
    f = (sign << 31) | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float r;
  std::memcpy(&r, &f, 4);
  return r;
}

uint16_t float_to_half(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  uint16_t sign = (uint16_t)((f >> 16) & 0x8000u);
  int fexp = (int)((f >> 23) & 0xffu);
  uint32_t mant = f & 0x7fffffu;
  if (fexp == 0xff) return sign | 0x7c00 | (mant ? 0x200 : 0);  // inf/nan
  int exp = fexp - 127 + 15;
  if (exp >= 31) return sign | 0x7c00;  // overflow -> inf
  if (exp <= 0) {
    if (exp < -10) return sign;  // underflow -> signed zero
    mant |= 0x800000u;
    return sign | (uint16_t)(mant >> (14 - exp));
  }
  return sign | (uint16_t)(exp << 10) | (uint16_t)(mant >> 13);
}

// ------------------------------------------------------------- parsing ----
struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if ((size_t)(end - p) < n) ok = false;
    return ok;
  }
  uint8_t u8() { return need(1) ? *p++ : 0; }
  int32_t i32() {
    if (!need(4)) return 0;
    int32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  int64_t i64() {
    if (!need(8)) return 0;
    int64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  // null-terminated string, bounded
  bool str(std::string* out, size_t maxlen = 256) {
    out->clear();
    while (p < end && *p != 0) {
      out->push_back((char)*p++);
      if (out->size() > maxlen) return ok = false;
    }
    if (p >= end) return ok = false;
    ++p;  // consume NUL
    return true;
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
};

struct Channel {
  std::string name;
  int32_t type;  // 0=UINT, 1=HALF, 2=FLOAT
  int bytes() const { return type == 1 ? 2 : 4; }
};

// OpenEXR "predictor + deinterleave" post-decompress reorder (applies to
// RLE / ZIPS / ZIP payloads).
void postprocess(uint8_t* buf, size_t n, uint8_t* scratch) {
  if (n == 0) return;
  for (size_t i = 1; i < n; ++i)
    buf[i] = (uint8_t)((int)buf[i - 1] + (int)buf[i] - 128);
  const uint8_t* t1 = buf;
  const uint8_t* t2 = buf + (n + 1) / 2;
  size_t s = 0;
  while (true) {
    if (s < n) scratch[s++] = *t1++; else break;
    if (s < n) scratch[s++] = *t2++; else break;
  }
  std::memcpy(buf, scratch, n);
}

// Inverse (pre-deflate) reorder for the writer.
void preprocess(const uint8_t* raw, size_t n, uint8_t* out) {
  uint8_t* t1 = out;
  uint8_t* t2 = out + (n + 1) / 2;
  size_t s = 0;
  while (true) {
    if (s < n) *t1++ = raw[s++]; else break;
    if (s < n) *t2++ = raw[s++]; else break;
  }
  uint8_t prev = out[0];
  for (size_t i = 1; i < n; ++i) {
    uint8_t cur = out[i];
    out[i] = (uint8_t)((int)cur - (int)prev + 128 + 256);
    prev = cur;
  }
}

int rle_decompress(const uint8_t* in, size_t in_n, uint8_t* out,
                   size_t out_n) {
  size_t o = 0, i = 0;
  while (i < in_n) {
    int c = (int)(int8_t)in[i++];
    if (c < 0) {
      size_t cnt = (size_t)(-c);
      if (i + cnt > in_n || o + cnt > out_n) return -1;
      std::memcpy(out + o, in + i, cnt);
      i += cnt;
      o += cnt;
    } else {
      size_t cnt = (size_t)c + 1;
      if (i >= in_n || o + cnt > out_n) return -1;
      std::memset(out + o, in[i++], cnt);
      o += cnt;
    }
  }
  return o == out_n ? 0 : -1;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  out->resize((size_t)n);
  size_t got = std::fread(out->data(), 1, (size_t)n, f);
  std::fclose(f);
  return got == (size_t)n;
}

}  // namespace

extern "C" {

void drtpu_free(float* p);  // provided by hdr_codec.cc

// Error codes: 1 io, 2 magic, 3 unsupported layout (tiled/deep/multipart),
// 4 bad header, 5 unsupported compression, 6 subsampled channels,
// 7 corrupt chunk data, 8 no usable channels.
int exr_read(const char* path, float** out, int* out_w, int* out_h) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return 1;
  Reader r{file.data(), file.data() + file.size()};

  if (r.i32() != 20000630) return 2;  // magic 0x01312f76 LE
  int32_t version = r.i32();
  if ((version & 0xff) != 2) return 2;
  if (version & (0x200 | 0x800 | 0x1000)) return 3;  // tiled/deep/multipart

  std::vector<Channel> channels;
  int compression = -1;
  int32_t xmin = 0, ymin = 0, xmax = -1, ymax = -1;
  int line_order = 0;

  while (r.ok) {  // attributes until empty name
    std::string name;
    if (!r.str(&name)) return 4;
    if (name.empty()) break;
    std::string type;
    if (!r.str(&type)) return 4;
    int32_t size = r.i32();
    if (size < 0 || !r.need((size_t)size)) return 4;
    const uint8_t* val = r.p;

    if (name == "channels" && type == "chlist") {
      Reader cr{val, val + size};
      while (cr.ok) {
        std::string cname;
        if (!cr.str(&cname)) return 4;
        if (cname.empty()) break;
        Channel c;
        c.name = cname;
        c.type = cr.i32();
        cr.skip(4);  // pLinear + reserved
        int32_t xs = cr.i32(), ys = cr.i32();
        if (xs != 1 || ys != 1) return 6;
        if (c.type < 0 || c.type > 2) return 4;
        channels.push_back(c);
      }
      if (!cr.ok) return 4;
    } else if (name == "compression" && type == "compression") {
      compression = val[0];
    } else if (name == "dataWindow" && type == "box2i") {
      std::memcpy(&xmin, val + 0, 4);
      std::memcpy(&ymin, val + 4, 4);
      std::memcpy(&xmax, val + 8, 4);
      std::memcpy(&ymax, val + 12, 4);
    } else if (name == "lineOrder" && type == "lineOrder") {
      line_order = val[0];
    }
    r.skip((size_t)size);
  }
  if (!r.ok) return 4;

  const int64_t w64 = (int64_t)xmax - xmin + 1;
  const int64_t h64 = (int64_t)ymax - ymin + 1;
  if (w64 <= 0 || h64 <= 0 || w64 * h64 > (int64_t)1 << 30) return 4;
  const int w = (int)w64, h = (int)h64;
  if (channels.empty()) return 4;

  int lines_per_block;
  switch (compression) {
    case 0: case 1: case 2: lines_per_block = 1; break;  // NONE, RLE, ZIPS
    case 3: lines_per_block = 16; break;                 // ZIP
    default: return 5;  // PIZ/PXR24/B44/DWA not supported
  }
  if (line_order != 0 && line_order != 1) return 5;

  size_t line_bytes = 0;
  for (const Channel& c : channels) line_bytes += (size_t)w * c.bytes();

  // Channel destinations: R,G,B; grayscale Y replicated; -1 = discard.
  int dst[3] = {-1, -1, -1};
  bool gray = false;
  for (size_t i = 0; i < channels.size(); ++i) {
    if (channels[i].name == "R") dst[0] = (int)i;
    if (channels[i].name == "G") dst[1] = (int)i;
    if (channels[i].name == "B") dst[2] = (int)i;
  }
  if (dst[0] < 0 && dst[1] < 0 && dst[2] < 0) {
    for (size_t i = 0; i < channels.size(); ++i)
      if (channels[i].name == "Y") dst[0] = dst[1] = dst[2] = (int)i;
    if (dst[0] < 0) dst[0] = dst[1] = dst[2] = 0;  // first channel
    gray = true;
  }
  (void)gray;

  const int num_blocks = (h + lines_per_block - 1) / lines_per_block;
  std::vector<int64_t> offsets((size_t)num_blocks);
  for (int i = 0; i < num_blocks; ++i) offsets[(size_t)i] = r.i64();
  if (!r.ok) return 4;

  float* rgb = (float*)std::malloc((size_t)w * h * 3 * sizeof(float));
  if (!rgb) return 1;
  std::memset(rgb, 0, (size_t)w * h * 3 * sizeof(float));

  std::vector<uint8_t> raw(line_bytes * (size_t)lines_per_block);
  std::vector<uint8_t> scratch(raw.size());

  for (int bi = 0; bi < num_blocks; ++bi) {
    int64_t off = offsets[(size_t)bi];
    if (off < 0 || (size_t)off + 8 > file.size()) { free(rgb); return 7; }
    Reader cr{file.data() + off, file.data() + file.size()};
    int32_t y = cr.i32();
    int32_t data_size = cr.i32();
    if (!cr.ok || data_size < 0 || !cr.need((size_t)data_size)) {
      free(rgb);
      return 7;
    }
    int rel = y - ymin;
    if (rel < 0 || rel >= h) { free(rgb); return 7; }
    int nlines = lines_per_block;
    if (rel + nlines > h) nlines = h - rel;
    size_t expected = line_bytes * (size_t)nlines;

    const uint8_t* payload = cr.p;
    if ((size_t)data_size == expected || compression == 0) {
      if ((size_t)data_size < expected) { free(rgb); return 7; }
      std::memcpy(raw.data(), payload, expected);
    } else if (compression == 1) {  // RLE
      if (rle_decompress(payload, (size_t)data_size, raw.data(), expected)) {
        free(rgb);
        return 7;
      }
      postprocess(raw.data(), expected, scratch.data());
    } else {  // ZIPS / ZIP
      uLongf dn = (uLongf)expected;
      if (uncompress(raw.data(), &dn, payload, (uLongf)data_size) != Z_OK ||
          dn != expected) {
        free(rgb);
        return 7;
      }
      postprocess(raw.data(), expected, scratch.data());
    }

    // Scatter scanlines into the RGB output.
    const uint8_t* line = raw.data();
    for (int li = 0; li < nlines; ++li, line += line_bytes) {
      int row = rel + li;  // chunk y coordinates are absolute either order
      float* out_row = rgb + (size_t)row * w * 3;
      size_t coff = 0;
      for (size_t ci = 0; ci < channels.size(); ++ci) {
        const Channel& c = channels[ci];
        int slot = -1;
        for (int s = 0; s < 3; ++s)
          if (dst[s] == (int)ci) slot = s;
        if (slot >= 0) {
          const uint8_t* src = line + coff;
          for (int x = 0; x < w; ++x) {
            float v;
            if (c.type == 1) {
              uint16_t hv;
              std::memcpy(&hv, src + (size_t)x * 2, 2);
              v = half_to_float(hv);
            } else if (c.type == 2) {
              std::memcpy(&v, src + (size_t)x * 4, 4);
            } else {
              uint32_t uv;
              std::memcpy(&uv, src + (size_t)x * 4, 4);
              v = (float)uv;
            }
            for (int s = 0; s < 3; ++s)
              if (dst[s] == (int)ci) out_row[x * 3 + s] = v;
          }
        }
        coff += (size_t)w * c.bytes();
      }
    }
  }

  *out = rgb;
  *out_w = w;
  *out_h = h;
  return 0;
}

// ZIP-compressed HALF R,G,B scanline writer.
int exr_write(const char* path, const float* rgb, int w, int h) {
  if (w <= 0 || h <= 0) return 1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;

  auto wr = [&](const void* p, size_t n) { std::fwrite(p, 1, n, f); };
  auto wi32 = [&](int32_t v) { wr(&v, 4); };
  auto wstr = [&](const char* s) { wr(s, std::strlen(s) + 1); };
  auto wattr = [&](const char* name, const char* type, int32_t size) {
    wstr(name);
    wstr(type);
    wi32(size);
  };

  wi32(20000630);
  wi32(2);  // version 2, scanline

  // channels: B, G, R (alphabetical, as required), HALF
  wattr("channels", "chlist", 3 * (1 + 1 + 4 + 4 + 8) + 1);
  for (const char* n : {"B", "G", "R"}) {
    wstr(n);
    wi32(1);  // HALF
    wi32(0);  // pLinear + reserved
    wi32(1);  // xSampling
    wi32(1);  // ySampling
  }
  { uint8_t z = 0; wr(&z, 1); }

  wattr("compression", "compression", 1);
  { uint8_t c = 3; wr(&c, 1); }  // ZIP
  wattr("dataWindow", "box2i", 16);
  wi32(0); wi32(0); wi32(w - 1); wi32(h - 1);
  wattr("displayWindow", "box2i", 16);
  wi32(0); wi32(0); wi32(w - 1); wi32(h - 1);
  wattr("lineOrder", "lineOrder", 1);
  { uint8_t lo = 0; wr(&lo, 1); }
  wattr("pixelAspectRatio", "float", 4);
  { float par = 1.0f; wr(&par, 4); }
  wattr("screenWindowCenter", "v2f", 8);
  { float c2[2] = {0, 0}; wr(c2, 8); }
  wattr("screenWindowWidth", "float", 4);
  { float sw = 1.0f; wr(&sw, 4); }
  { uint8_t z = 0; wr(&z, 1); }  // end of header

  const int lpb = 16;
  const int num_blocks = (h + lpb - 1) / lpb;
  const size_t line_bytes = (size_t)w * 3 * 2;

  // Reserve the offset table; patch after writing chunks.
  long table_pos = std::ftell(f);
  std::vector<int64_t> offsets((size_t)num_blocks, 0);
  wr(offsets.data(), (size_t)num_blocks * 8);

  std::vector<uint8_t> raw(line_bytes * lpb);
  std::vector<uint8_t> pre(raw.size());
  std::vector<uint8_t> comp(compressBound((uLong)raw.size()));

  for (int bi = 0; bi < num_blocks; ++bi) {
    int y0 = bi * lpb;
    int nlines = (y0 + lpb > h) ? h - y0 : lpb;
    size_t n = line_bytes * (size_t)nlines;
    for (int li = 0; li < nlines; ++li) {
      uint8_t* line = raw.data() + line_bytes * (size_t)li;
      const float* src = rgb + (size_t)(y0 + li) * w * 3;
      // channel order B, G, R
      for (int ci = 0; ci < 3; ++ci) {
        int comp_idx = 2 - ci;  // B<-2, G<-1, R<-0
        uint8_t* cdst = line + (size_t)ci * w * 2;
        for (int x = 0; x < w; ++x) {
          uint16_t hv = float_to_half(src[x * 3 + comp_idx]);
          std::memcpy(cdst + (size_t)x * 2, &hv, 2);
        }
      }
    }
    preprocess(raw.data(), n, pre.data());
    uLongf cn = (uLongf)comp.size();
    const uint8_t* payload;
    size_t payload_n;
    if (compress2(comp.data(), &cn, pre.data(), (uLong)n, 6) == Z_OK &&
        cn < n) {
      payload = comp.data();
      payload_n = cn;
    } else {
      payload = raw.data();
      payload_n = n;
    }
    offsets[(size_t)bi] = (int64_t)std::ftell(f);
    wi32(y0);
    wi32((int32_t)payload_n);
    wr(payload, payload_n);
  }

  std::fseek(f, table_pos, SEEK_SET);
  wr(offsets.data(), (size_t)num_blocks * 8);
  int rc = std::fclose(f) == 0 ? 0 : 1;
  return rc;
}

}  // extern "C"
