// Native host runtime of the PyTorch port (C ABI, loaded via ctypes).
//
// The reference delegates its host-side hot paths to C++ libraries (Open3D
// voxel downsample / KD-trees, libpng via PIL). What stays on the host —
// depth-PNG decode and preprocessing in the dataloaders, PLY packing, and
// host versions of the voxel/radius ops — lives here.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -DPRGPT_HAVE_ZLIB -lz
// (pointreggpt_tpu_torch/native.py builds it into _build/ on first use).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

// PNG decode needs zlib; everything else does not. The build tries with
// -lz -DPRGPT_HAVE_ZLIB first and retries without on hosts lacking zlib
// dev headers (pointreggpt_tpu_torch/native.py::_build), in which case the
// png16_* entry points become stubs returning "unsupported" so callers
// fall back to PIL while depth_preprocess/voxel/radius/ply stay native.
#ifdef PRGPT_HAVE_ZLIB
#include <zlib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Depth preprocessing: raw uint16 mm frame -> model-space float32 [0,1].
// NEAREST short-side resize (PIL pixel mapping: src = floor((i+0.5)/scale)),
// center crop (round-half-up offsets, torchvision parity), scale 1e-4,
// clip >1 -> 0, optional horizontal flip.  Reference pipeline: sdd:1535-1554.
// out must hold out_size*out_size floats. Returns 0 on success.
int depth_preprocess(const uint16_t* raw, int h, int w, int out_size,
                     int flip, float* out) {
  if (h <= 0 || w <= 0 || out_size <= 0) return 1;
  // short-side resize dims; long side TRUNCATED like torchvision's
  // int(size * long / short) (sdd:1537) and intrinsic_transform's floor
  int new_h, new_w;
  if (h <= w) {
    new_h = out_size;
    new_w = (int)((double)out_size * w / h);
  } else {
    new_w = out_size;
    new_h = (int)((double)out_size * h / w);
  }
  if (new_h < out_size || new_w < out_size) return 2;
  // center-crop offsets (round half to even: Python round() parity)
  const int top = (int)std::nearbyint((new_h - out_size) / 2.0);
  const int left = (int)std::nearbyint((new_w - out_size) / 2.0);

  const double sy = (double)h / new_h;
  const double sx = (double)w / new_w;
  for (int r = 0; r < out_size; ++r) {
    // PIL NEAREST: src index = floor((dst + 0.5) * scale)
    int sr = (int)((r + top + 0.5) * sy);
    if (sr >= h) sr = h - 1;
    const uint16_t* row = raw + (size_t)sr * w;
    for (int c = 0; c < out_size; ++c) {
      // flip BEFORE the crop (reference transform order Resize ->
      // RandomHorizontalFlip -> CenterCrop, sdd:1535-1542): output col c
      // reads flipped-resized col left+c == resized col new_w-1-left-c
      int rc = flip ? (new_w - 1 - left - c) : (left + c);
      int sc = (int)((rc + 0.5) * sx);
      if (sc >= w) sc = w - 1;
      float v = row[sc] * 1e-4f;
      out[(size_t)r * out_size + c] = (v > 1.0f) ? 0.0f : v;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Voxel-grid downsample (host fallback; Open3D semantics:
// floor((p - (min - v/2))/v) — VoxelDownSample's half-cell-shifted origin —
// centroid per occupied voxel).  Returns the number of output points
// (<= n); out must hold n*3 floats.
int voxel_downsample(const float* pts, int64_t n, float voxel, float* out) {
  if (n <= 0) return 0;
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k)
      if (pts[i * 3 + k] < mn[k]) mn[k] = pts[i * 3 + k];

  struct Acc {
    double s[3] = {0, 0, 0};
    int64_t cnt = 0;
    int64_t order = 0;
  };
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve((size_t)n);
  int64_t next_order = 0;
  // Open3D convention: quantization origin is min_bound - voxel/2
  // (VoxelDownSample's half-cell shift), matching core/pointops.py
  for (int k = 0; k < 3; ++k) mn[k] -= 0.5f * voxel;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = 0;
    for (int k = 0; k < 3; ++k) {
      int64_t q = (int64_t)std::floor((pts[i * 3 + k] - mn[k]) / voxel);
      key = key * 2097152u + (uint64_t)(q & 0x1FFFFF);  // 21 bits/axis
    }
    Acc& a = cells[key];
    if (a.cnt == 0) a.order = next_order++;
    for (int k = 0; k < 3; ++k) a.s[k] += pts[i * 3 + k];
    a.cnt++;
  }
  // deterministic output: first-occurrence order
  std::vector<const Acc*> ordered(cells.size());
  for (const auto& kv : cells) ordered[(size_t)kv.second.order] = &kv.second;
  int64_t m = 0;
  for (const Acc* a : ordered) {
    for (int k = 0; k < 3; ++k)
      out[m * 3 + k] = (float)(a->s[k] / a->cnt);
    ++m;
  }
  return (int)m;
}

// ---------------------------------------------------------------------------
// Radius-hit test (host fallback for overlap computation): for each src
// point, 1 if any tgt point lies within radius. Uniform-grid hash over tgt.
// hits must hold n_src uint8.
void radius_hits(const float* src, int64_t n_src, const float* tgt,
                 int64_t n_tgt, float radius, uint8_t* hits) {
  std::memset(hits, 0, (size_t)n_src);
  if (n_src <= 0 || n_tgt <= 0) return;
  const float cell = radius;
  std::unordered_map<uint64_t, std::vector<int64_t>> grid;
  grid.reserve((size_t)n_tgt);
  auto key_of = [cell](const float* p) -> uint64_t {
    uint64_t key = 0;
    for (int k = 0; k < 3; ++k) {
      int64_t q = (int64_t)std::floor(p[k] / cell);
      key = key * 2097152u + (uint64_t)(q & 0x1FFFFF);
    }
    return key;
  };
  for (int64_t j = 0; j < n_tgt; ++j) grid[key_of(tgt + j * 3)].push_back(j);

  const float r2 = radius * radius;
  for (int64_t i = 0; i < n_src; ++i) {
    const float* s = src + i * 3;
    bool hit = false;
    for (int dx = -1; dx <= 1 && !hit; ++dx)
      for (int dy = -1; dy <= 1 && !hit; ++dy)
        for (int dz = -1; dz <= 1 && !hit; ++dz) {
          float probe[3] = {s[0] + dx * cell, s[1] + dy * cell,
                            s[2] + dz * cell};
          auto it = grid.find(key_of(probe));
          if (it == grid.end()) continue;
          for (int64_t j : it->second) {
            const float* t = tgt + j * 3;
            float d0 = s[0] - t[0], d1 = s[1] - t[1], d2 = s[2] - t[2];
            if (d0 * d0 + d1 * d1 + d2 * d2 <= r2) {
              hit = true;
              break;
            }
          }
        }
    hits[i] = hit ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Minimal 16-bit grayscale PNG decoder (zlib inflate + unfilter). The
// training dataloader's true host bottleneck was PIL/zlib *Python-side*
// decode of the 3DMatch depth frames (sdd:1550: PIL.Image.open per item);
// resize/crop/scale was already native but decode was not. Supports exactly
// the production format — bit depth 16, color type 0 (grayscale),
// deflate, filters 0-4, non-interlaced (what 3DMatch ships and cv2
// writes); anything else returns an error and callers fall back to PIL.

#ifdef PRGPT_HAVE_ZLIB

static inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static const uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

// Parse IHDR. Returns 0 and fills (*h, *w) for a decodable image; >0 error.
int png16_dims(const uint8_t* data, int64_t n, int* h, int* w) {
  if (n < 33 || std::memcmp(data, kPngSig, 8) != 0) return 1;
  if (be32(data + 8) != 13 || std::memcmp(data + 12, "IHDR", 4) != 0)
    return 2;
  uint32_t width = be32(data + 16), height = be32(data + 20);
  uint8_t bit_depth = data[24], color_type = data[25];
  uint8_t compression = data[26], filter = data[27], interlace = data[28];
  // cap total pixels (64 Mpix; production frames are 640x480): a corrupt
  // IHDR claiming huge dims would otherwise reach the decode buffers and
  // throw std::bad_alloc, which cannot cross the C ABI — std::terminate
  // would kill the whole training process instead of one frame.
  if (width == 0 || height == 0 || width > (1u << 16) ||
      height > (1u << 16) || (uint64_t)width * height > (1ull << 26))
    return 3;
  if (bit_depth != 16 || color_type != 0) return 4;  // not 16-bit gray
  if (compression != 0 || filter != 0 || interlace != 0) return 5;
  *h = (int)height;
  *w = (int)width;
  return 0;
}

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode into out (h*w native-endian uint16, row-major). Returns 0 ok.
int png16_decode(const uint8_t* data, int64_t n, uint16_t* out,
                 int64_t out_capacity) {
  int h, w;
  int rc = png16_dims(data, n, &h, &w);
  if (rc != 0) return rc;
  if ((int64_t)h * w > out_capacity) return 6;

  const size_t rowbytes = (size_t)w * 2;
  const size_t raw_size = (size_t)h * (rowbytes + 1);
  std::vector<uint8_t> raw(raw_size);

  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return 7;
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw_size;

  // walk chunks, feeding every IDAT straight into inflate (no concat copy)
  int64_t off = 8;
  bool done = false;
  int zrc = Z_OK;
  while (off + 12 <= n && !done) {
    uint32_t len = be32(data + off);
    const uint8_t* type = data + off + 4;
    if (off + 12 + (int64_t)len > n) break;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      zs.next_in = const_cast<uint8_t*>(data + off + 8);
      zs.avail_in = len;
      zrc = inflate(&zs, Z_NO_FLUSH);
      if (zrc == Z_STREAM_END) done = true;
      else if (zrc != Z_OK && zrc != Z_BUF_ERROR) break;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + (int64_t)len;
  }
  bool complete = (zs.total_out == raw_size);
  inflateEnd(&zs);
  if (!complete) return 8;

  // unfilter (bpp = 2) + big-endian -> native
  std::vector<uint8_t> prev(rowbytes, 0);
  for (int r = 0; r < h; ++r) {
    uint8_t* row = raw.data() + (size_t)r * (rowbytes + 1);
    uint8_t ftype = row[0];
    uint8_t* cur = row + 1;
    switch (ftype) {
      case 0:
        break;
      case 1:  // sub
        for (size_t i = 2; i < rowbytes; ++i) cur[i] += cur[i - 2];
        break;
      case 2:  // up
        for (size_t i = 0; i < rowbytes; ++i) cur[i] += prev[i];
        break;
      case 3:  // average
        for (size_t i = 0; i < 2; ++i) cur[i] += prev[i] / 2;
        for (size_t i = 2; i < rowbytes; ++i)
          cur[i] += (uint8_t)(((int)cur[i - 2] + prev[i]) / 2);
        break;
      case 4:  // paeth
        for (size_t i = 0; i < 2; ++i)
          cur[i] += (uint8_t)paeth(0, prev[i], 0);
        for (size_t i = 2; i < rowbytes; ++i)
          cur[i] += (uint8_t)paeth(cur[i - 2], prev[i], prev[i - 2]);
        break;
      default:
        return 9;
    }
    uint16_t* dst = out + (size_t)r * w;
    for (int c = 0; c < w; ++c)
      dst[c] = (uint16_t)((cur[2 * c] << 8) | cur[2 * c + 1]);
    std::memcpy(prev.data(), cur, rowbytes);
  }
  return 0;
}

// Fused decode + model-space preprocessing: PNG bytes -> (out_size^2)
// float32 [0,1], one call per dataloader item. Returns 0 ok.
int png16_depth_preprocess(const uint8_t* data, int64_t n, int out_size,
                           int flip, float* out) {
  int h, w;
  int rc = png16_dims(data, n, &h, &w);
  if (rc != 0) return rc;
  std::vector<uint16_t> raw((size_t)h * w);
  rc = png16_decode(data, n, raw.data(), (int64_t)h * w);
  if (rc != 0) return rc;
  return depth_preprocess(raw.data(), h, w, out_size, flip, out);
}

#else  // !PRGPT_HAVE_ZLIB — stubs report "unsupported", callers use PIL

int png16_dims(const uint8_t*, int64_t, int*, int*) { return 5; }
int png16_decode(const uint8_t*, int64_t, uint16_t*, int64_t) { return 5; }
int png16_depth_preprocess(const uint8_t*, int64_t, int, int, float*) {
  return 5;
}

#endif  // PRGPT_HAVE_ZLIB

// ---------------------------------------------------------------------------
// Binary little-endian PLY vertex packing: writes header + float32 xyz body
// into buf. Returns the number of bytes written, or -1 if buf_size too
// small.  (File IO stays in Python; this packs the bytes.)
int64_t ply_pack(const float* pts, int64_t n, char* buf, int64_t buf_size) {
  char header[256];
  int hlen = std::snprintf(header, sizeof(header),
                           "ply\nformat binary_little_endian 1.0\n"
                           "element vertex %lld\n"
                           "property float x\nproperty float y\n"
                           "property float z\nend_header\n",
                           (long long)n);
  int64_t total = hlen + n * 12;
  if (total > buf_size) return -1;
  std::memcpy(buf, header, (size_t)hlen);
  std::memcpy(buf + hlen, pts, (size_t)(n * 12));
  return total;
}

}  // extern "C"
