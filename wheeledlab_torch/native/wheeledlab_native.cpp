// Host-side runtime library of the PyTorch port (C ABI, loaded with ctypes
// by wheeledlab_torch/native/__init__.py; built with the host C++ compiler
// by wheeledlab_torch/ops/build.py::build_host). Plain C++ on the CPU, no
// CUDA:
//  - traversability map generation (reference: numpy/scipy random walkers +
//    binary_dilation, visual/utils/__init__.py:95-205): a walker/dilation
//    core with its own SplitMix64 stream;
//  - trajectory frame rasterization (reference: RTX render + PyAV encode,
//    custom_video_recorder.py): per-car trails, disks and heading dots for
//    the top-down videos.
//
// The same algorithms and streams as the JAX package's copy of this file,
// so both packages draw the same maps and frames.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// SplitMix64 — tiny deterministic PRNG (public algorithm).
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // uniform integer in [0, n)
  int64_t below(int64_t n) { return static_cast<int64_t>(next() % static_cast<uint64_t>(n)); }
};

inline uint8_t& at(uint8_t* grid, int64_t cols, int64_t r, int64_t c) {
  return grid[r * cols + c];
}

// Random-order manhattan walk carving 1s (port of generate_path,
// reference visual/utils/__init__.py:123-147).
void generate_path(int64_t sr, int64_t sc, int64_t er, int64_t ec,
                   uint8_t* grid, int64_t cols, Rng& rng) {
  int64_t row_diff = er - sr, col_diff = ec - sc;
  std::vector<int8_t> actions;  // 0:-row 1:+row 2:-col 3:+col
  actions.reserve(std::abs(row_diff) + std::abs(col_diff));
  for (int64_t i = 0; i < std::abs(row_diff); ++i)
    actions.push_back(row_diff < 0 ? 0 : 1);
  for (int64_t i = 0; i < std::abs(col_diff); ++i)
    actions.push_back(col_diff < 0 ? 2 : 3);
  // Fisher-Yates shuffle
  for (int64_t i = static_cast<int64_t>(actions.size()) - 1; i > 0; --i) {
    int64_t j = rng.below(i + 1);
    std::swap(actions[i], actions[j]);
  }
  int64_t r = sr, c = sc;
  at(grid, cols, r, c) = 1;
  for (int8_t a : actions) {
    if (a == 0) --r; else if (a == 1) ++r; else if (a == 2) --c; else ++c;
    at(grid, cols, r, c) = 1;
  }
}

}  // namespace

extern "C" {

// Carve corridors into grid[rows*cols] (uint8, zero-initialized by caller),
// sub-env by sub-env, then dilate with the asymmetric L1 structure
// [[0,1,0],[0,1,1],[0,0,0]] (reference :84-86). Deterministic in `seed`.
void wl_generate_traversability_map(
    uint64_t seed, int64_t rows, int64_t cols,
    int64_t env_rows, int64_t env_cols,
    int64_t group_rows, int64_t group_cols,
    int64_t num_walkers, uint8_t* grid) {
  Rng rng(seed);
  for (int64_t ei = 0; ei < rows / env_rows; ++ei) {
    for (int64_t ej = 0; ej < cols / env_cols; ++ej) {
      const int64_t r0 = ei * env_rows, c0 = ej * env_cols;
      // start points: one random cell per group
      std::vector<std::pair<int64_t, int64_t>> starts;
      for (int64_t gi = 0; gi < env_rows / group_rows; ++gi)
        for (int64_t gj = 0; gj < env_cols / group_cols; ++gj)
          starts.emplace_back(rng.below(group_rows) + gi * group_rows,
                              rng.below(group_cols) + gj * group_cols);
      for (auto& [sr, sc] : starts) {
        for (int64_t w = 0; w < num_walkers; ++w) {
          int64_t er = rng.below(env_rows), ec = rng.below(env_cols);
          while (at(grid, cols, r0 + er, c0 + ec)) {
            er = rng.below(env_rows);
            ec = rng.below(env_cols);
          }
          // carve within the sub-env (walk in local coords, offset applied)
          std::vector<uint8_t> local(env_rows * env_cols, 0);
          // copy current sub-env state in (walk must see carved cells? the
          // reference walks on the sub-env grid it is carving)
          for (int64_t r = 0; r < env_rows; ++r)
            std::memcpy(local.data() + r * env_cols,
                        grid + (r0 + r) * cols + c0, env_cols);
          generate_path(sr, sc, er, ec, local.data(), env_cols, rng);
          for (int64_t r = 0; r < env_rows; ++r)
            std::memcpy(grid + (r0 + r) * cols + c0,
                        local.data() + r * env_cols, env_cols);
        }
      }
    }
  }
  // dilation with structure offsets (relative to center of 3x3):
  // (dr, dc) in {(-1, 0) [up], (0, 0), (0, +1) [right]}
  std::vector<uint8_t> src(grid, grid + rows * cols);
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < cols; ++c) {
      if (src[r * cols + c]) continue;
      uint8_t v = 0;
      if (r + 1 < rows && src[(r + 1) * cols + c]) v = 1;       // up-shifted
      else if (c - 1 >= 0 && src[r * cols + (c - 1)]) v = 1;    // right-shifted
      grid[r * cols + c] = v;
    }
  }
}

// Rasterize trajectory frames: draw per-car trails + heading dots onto a
// prerendered background. frames: (T, size, size, 3) uint8, preloaded with
// the background in every frame. positions_px: (T, B, 2) float32 pixel
// coords; yaws: (T, B) float32 (screen convention); colors: (B, 3) uint8.
void wl_rasterize_trajectories(
    int64_t T, int64_t B, int64_t size, int64_t trail,
    const float* positions_px, const float* yaws, const uint8_t* colors,
    uint8_t* frames) {
  auto draw_disk = [&](uint8_t* frame, float cx, float cy, float rad,
                       const uint8_t* col) {
    int64_t y0 = std::max<int64_t>(0, static_cast<int64_t>(cy - rad));
    int64_t y1 = std::min<int64_t>(size - 1, static_cast<int64_t>(cy + rad));
    int64_t x0 = std::max<int64_t>(0, static_cast<int64_t>(cx - rad));
    int64_t x1 = std::min<int64_t>(size - 1, static_cast<int64_t>(cx + rad));
    for (int64_t y = y0; y <= y1; ++y)
      for (int64_t x = x0; x <= x1; ++x)
        if ((y - cy) * (y - cy) + (x - cx) * (x - cx) <= rad * rad)
          std::memcpy(frame + (y * size + x) * 3, col, 3);
  };
  for (int64_t t = 0; t < T; ++t) {
    uint8_t* frame = frames + t * size * size * 3;
    for (int64_t b = 0; b < B; ++b) {
      const uint8_t* col = colors + b * 3;
      uint8_t half[3] = {static_cast<uint8_t>(col[0] / 2),
                         static_cast<uint8_t>(col[1] / 2),
                         static_cast<uint8_t>(col[2] / 2)};
      for (int64_t s = std::max<int64_t>(0, t - trail); s < t; ++s) {
        const float* p = positions_px + (s * B + b) * 2;
        draw_disk(frame, p[0], p[1], 1.0f, half);
      }
      const float* p = positions_px + (t * B + b) * 2;
      draw_disk(frame, p[0], p[1], 3.5f, col);
      if (yaws) {
        float yaw = yaws[t * B + b];
        draw_disk(frame, p[0] + 6.0f * std::cos(yaw),
                  p[1] - 6.0f * std::sin(yaw), 1.5f, col);
      }
    }
  }
}

}  // extern "C"
