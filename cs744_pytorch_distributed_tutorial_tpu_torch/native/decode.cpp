// Native CIFAR-10 binary-format decoder: the torchvision-C-extension
// analog for the dataset's official binary distribution
// (cifar-10-binary.tar.gz). Each record is 3073 bytes: 1 label byte
// followed by a 3x32x32 CHW pixel plane. Decoding = split labels out and
// transpose CHW -> HWC (the layout the loader ships; data/augment.py
// permutes on the card) — a pure memory permutation, threaded over
// records.
//
// The reference reads the *pickle* distribution through torchvision's
// Python/C stack (master/part1/part1.py:78-79); data/cifar10.py reads
// that format in Python and routes the binary format here.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {
constexpr int64_t kH = 32, kW = 32, kC = 3;
constexpr int64_t kPlane = kH * kW;          // 1024
constexpr int64_t kRecord = 1 + kC * kPlane; // 3073
}  // namespace

extern "C" {

// records: [n * 3073] bytes; labels_out: [n] int32; images_out:
// [n, 32, 32, 3] uint8 (C-contiguous). Returns 0 on success, -1 on bad
// arguments.
int decode_cifar_u8(const uint8_t* records,
                    int64_t n,
                    int32_t* labels_out,
                    uint8_t* images_out,
                    int num_threads) {
  if (!records || !labels_out || !images_out || n < 0) return -1;
  if (num_threads < 1) num_threads = 1;
  const int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  num_threads = static_cast<int>(
      std::min<int64_t>(num_threads, std::max<int64_t>(hw, 1)));
  if (n * kRecord < (1 << 20)) num_threads = 1;  // spawn overhead floor

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = records + i * kRecord;
      labels_out[i] = static_cast<int32_t>(rec[0]);
      const uint8_t* r = rec + 1;
      const uint8_t* g = r + kPlane;
      const uint8_t* b = g + kPlane;
      uint8_t* out = images_out + i * kC * kPlane;
      for (int64_t p = 0; p < kPlane; ++p) {
        out[p * kC + 0] = r[p];
        out[p * kC + 1] = g[p];
        out[p * kC + 2] = b[p];
      }
    }
  };
  if (num_threads == 1) {
    worker(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
