// Native data-plane kernels for the host input pipeline.
//
// Counterpart of the reference's native dataloader stack (torch
// DataLoader worker processes + blosc C codec, reference train_ENARF_GAN.py:56-63,
// dataset/dataset.py:159): multithreaded, GIL-free batch assembly primitives
// exposed via ctypes (see native/__init__.py).
//
//   normalize_u8_to_f32   uint8 HWC/CHW images -> float32 [-1, 1] (x/127.5 - 1)
//   mask_from_alpha       uint8 alpha channel -> float32 [0, 1]
//   gather_rows_f32       row gather (batch assembly / pixel gather on host)
//
// Built on first use by native/__init__.py (g++ -O3 -shared -fPIC ... -lpthread).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

template <typename F>
void parallel_for(int64_t n, int threads, F&& body) {
  if (threads <= 1 || n < (1 << 16)) {
    body(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    pool.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// out[i] = in[i] / 127.5 - 1
void normalize_u8_to_f32(const uint8_t* in, float* out, int64_t n,
                         int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    constexpr float kScale = 1.0f / 127.5f;
    for (int64_t i = lo; i < hi; ++i) out[i] = in[i] * kScale - 1.0f;
  });
}

// out[i] = in[i] / 255
void mask_from_alpha(const uint8_t* in, float* out, int64_t n, int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    constexpr float kScale = 1.0f / 255.0f;
    for (int64_t i = lo; i < hi; ++i) out[i] = in[i] * kScale;
  });
}

// out[r, :] = table[idx[r], :]  (row_len floats per row)
void gather_rows_f32(const float* table, const int64_t* idx, float* out,
                     int64_t n_rows, int64_t row_len, int threads) {
  parallel_for(n_rows, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(out + r * row_len, table + idx[r] * row_len,
                  sizeof(float) * row_len);
    }
  });
}

// Stack + normalize a batch of uint8 CHW images given pointers
void assemble_batch_u8_to_f32(const uint8_t* const* imgs, float* out,
                              int64_t batch, int64_t per_img, int threads) {
  parallel_for(batch, threads, [&](int64_t lo, int64_t hi) {
    constexpr float kScale = 1.0f / 127.5f;
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* src = imgs[b];
      float* dst = out + b * per_img;
      for (int64_t i = 0; i < per_img; ++i) dst[i] = src[i] * kScale - 1.0f;
    }
  });
}

}  // extern "C"
