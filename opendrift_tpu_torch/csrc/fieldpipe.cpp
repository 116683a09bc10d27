// fieldpipe: native forcing-frame pipeline kernels.
//
// The reference delegates its block preparation to C libraries
// (scipy.ndimage map_coordinates/grey_dilation, netCDF4/HDF5 decode —
// SURVEY.md §2.9); this translation unit provides the equivalent
// host-side hot loops for the TPU build's packed-window loader:
//
//   * decode_i16:   int16 -> float32 with scale/offset and fill-value
//                   masking (the CF unpack inner loop)
//   * fill_nearest: replace NaNs with the nearest valid value per 2D
//                   layer via a two-pass chamfer distance transform
//                   (replaces scipy.ndimage.distance_transform_edt)
//   * fill_seafloor: propagate the last valid value down the z axis
//
// Layer loops are parallelised with std::thread.  Exposed with plain C
// linkage for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

void fill_nearest_layer(float* f, int ny, int nx) {
  // two-pass chamfer nearest-feature transform: track, per cell, the
  // squared distance to and value of the nearest finite cell.
  std::vector<float> dist(static_cast<size_t>(ny) * nx);
  std::vector<float> val(static_cast<size_t>(ny) * nx);
  bool any_valid = false;
  for (int i = 0; i < ny * nx; ++i) {
    if (std::isfinite(f[i])) {
      dist[i] = 0.f;
      val[i] = f[i];
      any_valid = true;
    } else {
      dist[i] = kInf;
      val[i] = 0.f;
    }
  }
  if (!any_valid) {
    std::memset(f, 0, sizeof(float) * ny * nx);
    return;
  }
  auto relax = [&](int idx, int nidx, float w) {
    if (dist[nidx] + w < dist[idx]) {
      dist[idx] = dist[nidx] + w;
      val[idx] = val[nidx];
    }
  };
  // forward pass (top-left -> bottom-right)
  for (int y = 0; y < ny; ++y) {
    for (int x = 0; x < nx; ++x) {
      int i = y * nx + x;
      if (x > 0) relax(i, i - 1, 1.f);
      if (y > 0) {
        relax(i, i - nx, 1.f);
        if (x > 0) relax(i, i - nx - 1, 1.4142f);
        if (x < nx - 1) relax(i, i - nx + 1, 1.4142f);
      }
    }
  }
  // backward pass
  for (int y = ny - 1; y >= 0; --y) {
    for (int x = nx - 1; x >= 0; --x) {
      int i = y * nx + x;
      if (x < nx - 1) relax(i, i + 1, 1.f);
      if (y < ny - 1) {
        relax(i, i + nx, 1.f);
        if (x < nx - 1) relax(i, i + nx + 1, 1.4142f);
        if (x > 0) relax(i, i + nx - 1, 1.4142f);
      }
    }
  }
  for (int i = 0; i < ny * nx; ++i) f[i] = val[i];
}

void parallel_layers(int nz, const std::function<void(int)>& fn) {
  unsigned n_threads = std::min<unsigned>(
      std::max(1u, std::thread::hardware_concurrency()),
      static_cast<unsigned>(nz));
  if (n_threads <= 1) {
    for (int z = 0; z < nz; ++z) fn(z);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      int z;
      while ((z = next.fetch_add(1)) < nz) fn(z);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// int16 -> float32 CF decode: out = raw*scale + offset; fill -> NaN.
void decode_i16(const int16_t* raw, float* out, long n, float scale,
                float offset, int16_t fill, int has_fill) {
  for (long i = 0; i < n; ++i) {
    if (has_fill && raw[i] == fill) {
      out[i] = std::numeric_limits<float>::quiet_NaN();
    } else {
      out[i] = static_cast<float>(raw[i]) * scale + offset;
    }
  }
}

// NaN -> nearest-valid per (ny, nx) layer; nz layers in parallel.
void fill_nearest(float* field, int nz, int ny, int nx) {
  parallel_layers(nz, [&](int z) {
    fill_nearest_layer(field + static_cast<size_t>(z) * ny * nx, ny, nx);
  });
}

// propagate the last finite value downward along z (axis 0).
void fill_seafloor(float* field, int nz, int ny, int nx) {
  const size_t layer = static_cast<size_t>(ny) * nx;
  for (int z = 1; z < nz; ++z) {
    float* cur = field + z * layer;
    const float* up = field + (z - 1) * layer;
    for (size_t i = 0; i < layer; ++i) {
      if (!std::isfinite(cur[i])) cur[i] = up[i];
    }
  }
}

}  // extern "C"
