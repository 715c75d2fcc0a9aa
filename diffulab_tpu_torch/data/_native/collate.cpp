// Native host-side data-path helper for the input pipeline (the port's copy
// of diffulab_tpu/data/_native/collate.cpp, with the same arithmetic, cut to
// the one entry point the port calls).
//
// The host input pipeline (normalize, collate) is plain CPU work that sits on
// the training critical path when per-step batches are large. This helper
// covers the hot per-batch transform, multithreaded over samples:
//
//   gather_normalize_u8:   stack N index-selected uint8 samples into one
//                          contiguous float32 batch, y = x * scale + bias
//                          (scale=1/127.5, bias=-1 gives the [-1, 1] range
//                          every dataset here uses)
//
// Built with plain g++ -O3 -march=native -shared at first use; bound via
// ctypes (diffulab_tpu_torch.data.native). No Python.h dependency.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Fused gather + u8->f32 normalize (latent-free pixel datasets: one pass
// from the raw uint8 store to the normalized batch).
void gather_normalize_u8(const uint8_t* src, const int64_t* indices, float* dst,
                         int64_t n_idx, int64_t sample_elems, float scale,
                         float bias, int n_threads) {
  auto work = [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = src + indices[i] * sample_elems;
      float* d = dst + i * sample_elems;
      for (int64_t j = 0; j < sample_elems; ++j)
        d[j] = static_cast<float>(s[j]) * scale + bias;
    }
  };
  if (n_threads <= 1 || n_idx * sample_elems < (1 << 16)) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t start = t * chunk;
    int64_t end = start + chunk < n_idx ? start + chunk : n_idx;
    if (start >= end) break;
    threads.emplace_back(work, start, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
