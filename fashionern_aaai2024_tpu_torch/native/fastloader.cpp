// Native data-loader core of the port: threaded batch assembly.
//
// A copy of fashionern_aaai2024_tpu/native/fastloader.cpp, kept in the
// port so that it builds from the port alone. Two memory-bound batch
// kernels as parallel C++:
//
//   * gather_rows_f32: scatter-gather of patch-pack rows into a
//     contiguous batch (data/patch_store.py get_batch);
//   * normalize_u8_to_f32: fused uint8 -> float32 (x * scale + shift)
//     CLIP normalization, NHWC, scale = 1 / (255 std), shift = -mean / std.
//
// Built at first use by native/__init__.py (native/build.py). The port
// has no numpy fallback: a failed build raises.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(first, last) over [0, total) in parallel chunks.
template <typename Fn>
void parallel_for(int64_t total, int64_t grain, Fn fn) {
  int workers = hardware_threads();
  int64_t chunks = (total + grain - 1) / grain;
  if (chunks < 2 || workers < 2) {
    fn(static_cast<int64_t>(0), total);
    return;
  }
  if (chunks > workers) chunks = workers;
  int64_t per = (total + chunks - 1) / chunks;
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(chunks));
  for (int64_t c = 0; c < chunks; ++c) {
    int64_t first = c * per;
    int64_t last = first + per > total ? total : first + per;
    if (first >= last) break;
    threads.emplace_back([=] { fn(first, last); });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// out[i] = pack[idx[i]] for row-major [n_rows, row_elems] f32 pack.
// Returns 0 on success, -1 on an out-of-range index.
int gather_rows_f32(const float* pack, int64_t n_rows, int64_t row_elems,
                    const int64_t* idx, int64_t n_idx, float* out) {
  std::atomic<int> status{0};
  parallel_for(n_idx, /*grain=*/64, [&](int64_t first, int64_t last) {
    for (int64_t i = first; i < last; ++i) {
      int64_t r = idx[i];
      if (r < 0 || r >= n_rows) {
        status.store(-1, std::memory_order_relaxed);
        return;
      }
      std::memcpy(out + i * row_elems, pack + r * row_elems,
                  static_cast<size_t>(row_elems) * sizeof(float));
    }
  });
  return status.load();
}

// Fused CLIP normalization: out = (src/255 - mean[c]) / std[c], NHWC
// uint8 → float32. n_pixels = N*H*W (3 channels each).
void normalize_u8_to_f32(const uint8_t* src, int64_t n_pixels,
                         const float* mean, const float* std_, float* out) {
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.0f / (255.0f * std_[c]);
    shift[c] = -mean[c] / std_[c];
  }
  parallel_for(n_pixels, /*grain=*/1 << 16, [&](int64_t first, int64_t last) {
    const uint8_t* s = src + first * 3;
    float* o = out + first * 3;
    for (int64_t i = first; i < last; ++i) {
      o[0] = static_cast<float>(s[0]) * scale[0] + shift[0];
      o[1] = static_cast<float>(s[1]) * scale[1] + shift[1];
      o[2] = static_cast<float>(s[2]) * scale[2] + shift[2];
      s += 3;
      o += 3;
    }
  });
}

}  // extern "C"
