// Spatial-hash neighbor-list builder (host side).
//
// Native replacement for the build stage of the reference's CUDA hash grid
// (wp.HashGrid, sim.py:123-127): bins points into cells of edge `radius`,
// then emits, for every point, all neighbors within `radius` (self excluded).
// The PyTorch port's own copy of softbody_tpu/native/hashgrid.cc, used by
// topology/neighbors.py (rest density and rest correction of the sparse
// scene build); the per-step pair kernels need no grid (static rest
// topology).
//
// Exposed via a plain C ABI for ctypes:
//   nb_count(...)  -> per-point neighbor counts (first pass)
//   nb_fill(...)   -> CSR-style fill of neighbor indices (second pass)
//
// Build: native/hashgrid.py (g++ -O3 -shared -fPIC, at first use).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <unordered_map>

namespace {

struct Grid {
  std::unordered_map<uint64_t, std::vector<int64_t>> cells;
  double inv_cell;
  double ox, oy, oz;

  static uint64_t key(int64_t cx, int64_t cy, int64_t cz) {
    // 21 bits per axis, offset to positive range
    const uint64_t B = 1u << 20;
    return ((uint64_t)(cx + B) << 42) | ((uint64_t)(cy + B) << 21) |
           (uint64_t)(cz + B);
  }

  void build(const double* pts, int64_t n, double cell) {
    inv_cell = 1.0 / cell;
    ox = oy = oz = 0.0;
    cells.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
      int64_t cx = (int64_t)std::floor(pts[3 * i + 0] * inv_cell);
      int64_t cy = (int64_t)std::floor(pts[3 * i + 1] * inv_cell);
      int64_t cz = (int64_t)std::floor(pts[3 * i + 2] * inv_cell);
      cells[key(cx, cy, cz)].push_back(i);
    }
  }

  template <typename F>
  void for_neighbors(const double* pts, int64_t i, double r2, F&& fn) const {
    const double x = pts[3 * i + 0], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const int64_t cx = (int64_t)std::floor(x * inv_cell);
    const int64_t cy = (int64_t)std::floor(y * inv_cell);
    const int64_t cz = (int64_t)std::floor(z * inv_cell);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = cells.find(key(cx + dx, cy + dy, cz + dz));
          if (it == cells.end()) continue;
          for (int64_t j : it->second) {
            if (j == i) continue;
            const double ddx = x - pts[3 * j + 0];
            const double ddy = y - pts[3 * j + 1];
            const double ddz = z - pts[3 * j + 2];
            if (ddx * ddx + ddy * ddy + ddz * ddz < r2) fn(j);
          }
        }
  }
};

}  // namespace

extern "C" {

// First pass: count neighbors per point.  Returns 0 on success.
int nb_count(const double* pts, int64_t n, double radius, int64_t* counts) {
  Grid g;
  g.build(pts, n, radius);
  const double r2 = radius * radius;
  for (int64_t i = 0; i < n; ++i) {
    int64_t c = 0;
    g.for_neighbors(pts, i, r2, [&](int64_t) { ++c; });
    counts[i] = c;
  }
  return 0;
}

// Second pass: fill neighbor indices into a CSR layout given row offsets.
// offsets has n+1 entries (exclusive prefix sum of counts); indices has
// offsets[n] entries.  Neighbor lists are sorted ascending.
int nb_fill(const double* pts, int64_t n, double radius,
            const int64_t* offsets, int64_t* indices) {
  Grid g;
  g.build(pts, n, radius);
  const double r2 = radius * radius;
  std::vector<int64_t> buf;
  for (int64_t i = 0; i < n; ++i) {
    buf.clear();
    g.for_neighbors(pts, i, r2, [&](int64_t j) { buf.push_back(j); });
    // insertion-sort small lists (K ~ tens)
    for (size_t a = 1; a < buf.size(); ++a) {
      int64_t v = buf[a];
      size_t b = a;
      while (b > 0 && buf[b - 1] > v) {
        buf[b] = buf[b - 1];
        --b;
      }
      buf[b] = v;
    }
    std::memcpy(indices + offsets[i], buf.data(), buf.size() * sizeof(int64_t));
  }
  return 0;
}

}  // extern "C"
