// Native data-loading kernels: gzip inflate + fused HU->density transfer.
//
// Host-side native component of diffdrr_tpu_torch's ingest path (the reference
// delegates to nibabel/torchio, diffdrr/data.py:44-227). The NumPy
// HU->density path makes ~8 full passes over the volume (three boolean
// masks, fancy indexing, min/max reductions, normalize) — ~2 GB of
// temporaries on a 512^3 CT. This implementation fuses the piecewise map
// and both reductions into two multithreaded passes with no temporaries.
// Compiled on demand with g++ -lz (native/build.py) and called via ctypes;
// diffdrr_tpu_torch/data.py and nifti.py keep their NumPy routes beside it.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

int n_threads(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  // Below ~1M voxels thread spawn overhead dominates.
  int64_t want = n / (1 << 20);
  return (int)std::max<int64_t>(1, std::min<int64_t>(hw, want + 1));
}

template <typename F>
void parallel_chunks(int64_t n, F&& fn) {
  const int t = n_threads(n);
  if (t == 1) {
    fn(0, 0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    const int64_t lo = i * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(i, lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// Fused transfer, templated on the stored HU dtype. Semantics match
// diffdrr_tpu_torch/data.py transform_hu_to_density (reference data.py:214-227):
// air (<= -800) -> min over soft voxels (or -800 if none), soft (-800, 350]
// -> identity, bone (> 350) -> value * bone_mult; then min-max normalize.
template <typename T>
void transfer(const T* hu, int64_t n, float bone_mult, float* out) {
  const int t = n_threads(n);
  std::vector<float> soft_mins((size_t)t, std::numeric_limits<float>::max());
  parallel_chunks(n, [&](int ti, int64_t lo, int64_t hi) {
    float m = std::numeric_limits<float>::max();
    for (int64_t i = lo; i < hi; ++i) {
      const float v = (float)hu[i];
      if (v > -800.f && v <= 350.f && v < m) m = v;
    }
    soft_mins[(size_t)ti] = m;
  });
  float soft_min = std::numeric_limits<float>::max();
  for (float m : soft_mins) soft_min = std::min(soft_min, m);
  if (soft_min == std::numeric_limits<float>::max()) soft_min = -800.f;

  // Pass 2: write mapped values, tracking per-thread min/max.
  std::vector<float> mins((size_t)t, std::numeric_limits<float>::max());
  std::vector<float> maxs((size_t)t, -std::numeric_limits<float>::max());
  parallel_chunks(n, [&](int ti, int64_t lo, int64_t hi) {
    float mn = std::numeric_limits<float>::max();
    float mx = -std::numeric_limits<float>::max();
    for (int64_t i = lo; i < hi; ++i) {
      const float v = (float)hu[i];
      float d;
      if (v <= -800.f) d = soft_min;
      else if (v <= 350.f) d = v;
      else d = v * bone_mult;
      out[i] = d;
      if (d < mn) mn = d;
      if (d > mx) mx = d;
    }
    mins[(size_t)ti] = mn;
    maxs[(size_t)ti] = mx;
  });
  float mn = std::numeric_limits<float>::max();
  float mx = -std::numeric_limits<float>::max();
  for (int i = 0; i < t; ++i) {
    mn = std::min(mn, mins[(size_t)i]);
    mx = std::max(mx, maxs[(size_t)i]);
  }
  const float peak = mx - mn;
  const float scale = peak > 0.f ? 1.f / peak : 1.f;
  parallel_chunks(n, [&](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = (out[i] - mn) * scale;
  });
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = int16, 2 = int32, 3 = float64, 4 = uint8.
int hu_to_density(const void* hu, int64_t n, int dtype, float bone_mult,
                  float* out) {
  switch (dtype) {
    case 0: transfer((const float*)hu, n, bone_mult, out); return 0;
    case 1: transfer((const int16_t*)hu, n, bone_mult, out); return 0;
    case 2: transfer((const int32_t*)hu, n, bone_mult, out); return 0;
    case 3: transfer((const double*)hu, n, bone_mult, out); return 0;
    case 4: transfer((const uint8_t*)hu, n, bone_mult, out); return 0;
    default: return -1;
  }
}

// Inflate a (possibly multi-member) gzip stream. Returns the decompressed
// size and fills *out with a malloc'd buffer the caller frees with nl_free,
// or a negative zlib error code.
int64_t gunzip(const uint8_t* src, int64_t n, uint8_t** out) {
  size_t cap = (size_t)std::max<int64_t>(n * 4, 1 << 20);
  uint8_t* buf = (uint8_t*)std::malloc(cap);
  if (!buf) return Z_MEM_ERROR;
  size_t total = 0;

  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  // 15 + 16: max window, gzip wrapper.
  if (inflateInit2(&zs, 15 + 16) != Z_OK) {
    std::free(buf);
    return Z_STREAM_ERROR;
  }
  for (;;) {
    if (total == cap) {
      cap *= 2;
      uint8_t* nb = (uint8_t*)std::realloc(buf, cap);
      if (!nb) { inflateEnd(&zs); std::free(buf); return Z_MEM_ERROR; }
      buf = nb;
    }
    zs.next_out = buf + total;
    zs.avail_out = (uInt)(cap - total);
    const int rc = inflate(&zs, Z_NO_FLUSH);
    total = cap - zs.avail_out;
    if (rc == Z_STREAM_END) {
      if (zs.avail_in == 0) break;          // done
      if (inflateReset2(&zs, 15 + 16) != Z_OK) break;  // next gzip member
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      inflateEnd(&zs);
      std::free(buf);
      return rc < 0 ? rc : Z_DATA_ERROR;
    } else if (rc == Z_BUF_ERROR && zs.avail_out > 0) {
      // Truncated input.
      inflateEnd(&zs);
      std::free(buf);
      return Z_DATA_ERROR;
    }
  }
  inflateEnd(&zs);
  *out = buf;
  return (int64_t)total;
}

void nl_free(void* p) { std::free(p); }

}  // extern "C"
