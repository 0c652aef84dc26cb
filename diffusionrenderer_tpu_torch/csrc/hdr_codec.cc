// Native HDR image codec: Radiance RGBE (.hdr) decode/encode + PFM decode.
//
// The port's own copy of diffusionrenderer_tpu/native/src/hdr_codec.cc, built
// on first use with the host compiler into build/ and loaded with ctypes by
// diffusionrenderer_tpu_torch/io.py.  No Python in the pixel loops.
//
// Format reference: Radiance file format (Ward, public domain spec).
// Scanline codecs handled: new RLE (0x02 0x02 hi lo), old RLE (1,1,1,n
// repeat markers), and flat RGBE.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct File {
  FILE* f = nullptr;
  explicit File(const char* path, const char* mode) { f = fopen(path, mode); }
  ~File() {
    if (f) fclose(f);
  }
};

inline void rgbe_to_float(const uint8_t rgbe[4], float* out) {
  if (rgbe[3] == 0) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const float scale = std::ldexp(1.0f, static_cast<int>(rgbe[3]) - (128 + 8));
  out[0] = rgbe[0] * scale;
  out[1] = rgbe[1] * scale;
  out[2] = rgbe[2] * scale;
}

inline void float_to_rgbe(const float rgb[3], uint8_t out[4]) {
  const float v = std::fmax(rgb[0], std::fmax(rgb[1], rgb[2]));
  if (v < 1e-32f) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  int e;
  const float scale = std::frexp(v, &e) * 256.0f / v;
  out[0] = static_cast<uint8_t>(rgb[0] * scale);
  out[1] = static_cast<uint8_t>(rgb[1] * scale);
  out[2] = static_cast<uint8_t>(rgb[2] * scale);
  out[3] = static_cast<uint8_t>(e + 128);
}

bool read_line(FILE* f, std::string* line) {
  line->clear();
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '\n') return true;
    line->push_back(static_cast<char>(c));
  }
  return !line->empty();
}

// Decode one new-RLE component strip of `width` bytes.
bool decode_rle_component(FILE* f, uint8_t* dst, int width) {
  int x = 0;
  while (x < width) {
    const int code = fgetc(f);
    if (code == EOF) return false;
    if (code > 128) {  // run
      const int count = code - 128;
      const int value = fgetc(f);
      if (value == EOF || x + count > width) return false;
      memset(dst + x, value, count);
      x += count;
    } else {  // literal
      const int count = code;
      if (count == 0 || x + count > width) return false;
      if (fread(dst + x, 1, count, f) != static_cast<size_t>(count))
        return false;
      x += count;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success.  *out is malloc'd (w*h*3 floats); free with
// drtpu_free.
int rgbe_read(const char* path, float** out, int* out_w, int* out_h) {
  File file(path, "rb");
  if (!file.f) return 1;
  std::string line;
  if (!read_line(file.f, &line) || line.rfind("#?", 0) != 0) return 2;

  bool format_ok = false;
  while (read_line(file.f, &line)) {
    if (line.empty()) break;  // header/body separator
    if (line.rfind("FORMAT=", 0) == 0) {
      format_ok = (line == "FORMAT=32-bit_rle_rgbe" ||
                   line == "FORMAT=32-bit_rle_xyze");
    }
  }
  if (!format_ok) return 3;

  if (!read_line(file.f, &line)) return 4;
  int w = 0, h = 0;
  // Canonical orientation "-Y H +X W"; accept any sign (we do not flip).
  if (sscanf(line.c_str(), "%*s %d %*s %d", &h, &w) != 2 || w <= 0 || h <= 0 ||
      static_cast<int64_t>(w) * h > (1ll << 30))
    return 5;

  float* data = static_cast<float*>(malloc(sizeof(float) * 3ull * w * h));
  if (!data) return 6;
  std::vector<uint8_t> scan(4ull * w);

  for (int y = 0; y < h; ++y) {
    uint8_t head[4];
    if (fread(head, 1, 4, file.f) != 4) {
      free(data);
      return 7;
    }
    if (head[0] == 2 && head[1] == 2 && ((head[2] << 8) | head[3]) == w &&
        w >= 8 && w < 32768) {
      // New RLE: four separate component strips.
      std::vector<uint8_t> comp(w);
      for (int c = 0; c < 4; ++c) {
        if (!decode_rle_component(file.f, comp.data(), w)) {
          free(data);
          return 8;
        }
        for (int x = 0; x < w; ++x) scan[4 * x + c] = comp[x];
      }
    } else {
      // Flat or old-RLE scanline; head already holds pixel 0.
      memcpy(scan.data(), head, 4);
      int x = 1;
      int shift = 0;
      while (x < w) {
        uint8_t px[4];
        if (fread(px, 1, 4, file.f) != 4) {
          free(data);
          return 9;
        }
        if (px[0] == 1 && px[1] == 1 && px[2] == 1) {  // old-RLE repeat
          const int count = px[3] << shift;
          if (x == 0 || x + count > w) {
            free(data);
            return 10;
          }
          for (int i = 0; i < count; ++i)
            memcpy(&scan[4ull * (x + i)], &scan[4ull * (x - 1)], 4);
          x += count;
          shift += 8;
        } else {
          memcpy(&scan[4ull * x], px, 4);
          ++x;
          shift = 0;
        }
      }
    }
    for (int x = 0; x < w; ++x)
      rgbe_to_float(&scan[4ull * x], &data[3ull * (static_cast<int64_t>(y) * w + x)]);
  }
  *out = data;
  *out_w = w;
  *out_h = h;
  return 0;
}

// Writes flat (uncompressed) RGBE — universally readable.  Returns 0 on ok.
int rgbe_write(const char* path, const float* data, int w, int h) {
  File file(path, "wb");
  if (!file.f) return 1;
  fprintf(file.f, "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n", h, w);
  std::vector<uint8_t> scan(4ull * w);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x)
      float_to_rgbe(&data[3ull * (static_cast<int64_t>(y) * w + x)],
                    &scan[4ull * x]);
    if (fwrite(scan.data(), 1, 4ull * w, file.f) != 4ull * w) return 2;
  }
  return 0;
}

// PFM: returns 0 on success; channels is 1 or 3; data is top-down rows.
int pfm_read(const char* path, float** out, int* out_w, int* out_h,
             int* out_c) {
  File file(path, "rb");
  if (!file.f) return 1;
  char tag[3] = {0};
  if (fscanf(file.f, "%2s", tag) != 1) return 2;
  const int channels = (strcmp(tag, "PF") == 0)   ? 3
                       : (strcmp(tag, "Pf") == 0) ? 1
                                                  : 0;
  if (!channels) return 3;
  int w, h;
  float scale;
  if (fscanf(file.f, "%d %d %f", &w, &h, &scale) != 3 || w <= 0 || h <= 0 ||
      static_cast<int64_t>(w) * h > (1ll << 30))
    return 4;
  fgetc(file.f);  // single whitespace after header
  const size_t n = static_cast<size_t>(w) * h * channels;
  float* data = static_cast<float*>(malloc(sizeof(float) * n));
  if (!data) return 5;
  // PFM stores rows bottom-up; normalize to top-down.
  for (int y = h - 1; y >= 0; --y) {
    if (fread(data + static_cast<size_t>(y) * w * channels, sizeof(float),
              static_cast<size_t>(w) * channels,
              file.f) != static_cast<size_t>(w) * channels) {
      free(data);
      return 6;
    }
  }
  const bool big_endian = scale > 0;
  if (big_endian) {
    auto* bytes = reinterpret_cast<uint8_t*>(data);
    for (size_t i = 0; i < n; ++i) {
      std::swap(bytes[4 * i], bytes[4 * i + 3]);
      std::swap(bytes[4 * i + 1], bytes[4 * i + 2]);
    }
  }
  const float s = std::fabs(scale);
  if (s != 1.0f && s > 0)
    for (size_t i = 0; i < n; ++i) data[i] *= s;
  *out = data;
  *out_w = w;
  *out_h = h;
  *out_c = channels;
  return 0;
}

void drtpu_free(float* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded batch loading: decode N files on a worker pool (frame sequences,
// per-frame HDRI environments).  Results are written into caller-indexed
// slots; per-file status codes are returned so one bad frame doesn't kill
// the batch.
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

extern "C" {

// paths: array of n C strings.  outs[i] receives a malloc'd buffer
// (ws[i]*hs[i]*3 floats) on success; status[i] = rgbe_read return code.
int rgbe_read_batch(const char** paths, int n, int num_threads,
                    float** outs, int* ws, int* hs, int* status) {
  if (n <= 0) return 0;
  num_threads = num_threads > 0 ? num_threads : 4;
  if (num_threads > n) num_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      outs[i] = nullptr;
      ws[i] = hs[i] = 0;
      status[i] = rgbe_read(paths[i], &outs[i], &ws[i], &hs[i]);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (status[i] != 0) return 1;  // caller inspects per-file status
  return 0;
}

}  // extern "C"
