// CPU oracle for Monotonic Alignment Search — the native counterpart of the
// reference's single native component (the Cython kernel, monotonic_align/
// core.pyx:9-45), rebuilt as plain C++ with std::thread batch parallelism.
//
// Semantics follow SURVEY.md §2.2 exactly (band-restricted forward max-sum
// sweep in float32, strict-< backtrack, ties keep the current token), so
// paths are bit-identical to both the reference algorithm and the CUDA
// kernel H1. Unlike the reference it does NOT mutate the caller's lattice
// (per-item scratch copies) and it actually runs the batch loop in
// parallel — the reference's documented build compiles its prange
// sequentially because setup.py never passes -fopenmp (setup.py:5-9).
//
// Build: g++ -O3 -shared -fPIC (driven by aligner_tpu_torch/native/build.py),
// loaded via ctypes — no Cython, no generated-C artifact in the tree.
// A copy of aligner_tpu/native/mas_cpu.cpp: the port imports nothing of
// the JAX package.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void mas_one(const float* value, int32_t* path, int32_t t_x, int32_t t_y,
             int32_t stride_y, float neg, float* scratch) {
  // scratch: t_x * t_y floats, C-contiguous [t_x, t_y].
  for (int32_t x = 0; x < t_x; ++x) {
    std::memcpy(scratch + x * t_y, value + x * stride_y,
                sizeof(float) * t_y);
  }
  auto cell = [&](int32_t x, int32_t y) -> float& {
    return scratch[x * t_y + y];
  };

  for (int32_t y = 0; y < t_y; ++y) {
    const int32_t lo = std::max<int32_t>(0, t_x + y - t_y);
    const int32_t hi = std::min<int32_t>(t_x, y + 1);
    for (int32_t x = lo; x < hi; ++x) {
      const float stay = (x == y) ? neg : cell(x, y - 1);
      float advance;
      if (x == 0) {
        advance = (y == 0) ? 0.0f : neg;
      } else {
        advance = cell(x - 1, y - 1);
      }
      // ties keep "stay" (reference max() lowering, core.c:19384-19391)
      const float best = (advance > stay) ? advance : stay;
      cell(x, y) = best + cell(x, y);
    }
  }

  int32_t index = t_x - 1;
  for (int32_t y = t_y - 1; y >= 0; --y) {
    path[index * stride_y + y] = 1;
    if (index != 0 &&
        (index == y || cell(index, y - 1) < cell(index - 1, y - 1))) {
      --index;
    }
  }
}

}  // namespace

extern "C" {

// value:  [b, t_x_max, t_y_max] float32 (not modified)
// path:   [b, t_x_max, t_y_max] int32, zero-initialised by the caller
// t_xs, t_ys: [b] int32 true lengths, must satisfy 1 <= t_x <= t_y
// returns 0 on success, -1 if any item violates the length contract
int mas_maximum_path_batch(const float* value, int32_t* path,
                           const int32_t* t_xs, const int32_t* t_ys,
                           int32_t b, int32_t t_x_max, int32_t t_y_max,
                           float max_neg_val, int32_t n_threads) {
  for (int32_t i = 0; i < b; ++i) {
    if (t_xs[i] < 1 || t_xs[i] > t_ys[i] || t_xs[i] > t_x_max ||
        t_ys[i] > t_y_max) {
      return -1;
    }
  }
  const int64_t item = static_cast<int64_t>(t_x_max) * t_y_max;
  if (n_threads < 1) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  n_threads = std::min<int32_t>(n_threads, b);

  auto worker = [&](int32_t tid) {
    std::vector<float> scratch(item);
    for (int32_t i = tid; i < b; i += n_threads) {
      mas_one(value + i * item, path + i * item, t_xs[i], t_ys[i], t_y_max,
              max_neg_val, scratch.data());
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
