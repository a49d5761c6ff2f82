// Native batch-assembly core: the multiprocess-DataLoader-worker analog.
//
// The reference's input pipeline leans on torchvision/libtorch native code:
// DataLoader with num_workers=2 worker processes and pinned staging buffers
// (master/part1/part1.py:80-93). Its hot host-side op — assembling a batch
// by gathering N example records into one contiguous buffer — happens in
// torch's C++ collate path. This is the port's equivalent: a small C++
// core doing the memcpy-bound index-gather with a thread pool, called
// from Python via ctypes, writing straight into the pinned staging
// buffer that the host-to-device copy reads (data/loader.py).
//
// Layout contract: `images` is a C-contiguous [num_examples, item_bytes]
// uint8 array; `indices` int64; `out` [num_indices, item_bytes]. The
// gather is pure memcpy so threads partition the index range with no
// shared writes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Gather rows of a uint8 matrix: out[i] = images[indices[i]].
// Returns 0 on success, -1 on a bad argument (null pointer or index out
// of range — checked up front so worker threads never fault).
int gather_u8(const uint8_t* images,
              int64_t num_examples,
              int64_t item_bytes,
              const int64_t* indices,
              int64_t num_indices,
              uint8_t* out,
              int num_threads) {
  if (!images || !indices || !out || item_bytes <= 0 || num_indices < 0) {
    return -1;
  }
  for (int64_t i = 0; i < num_indices; ++i) {
    if (indices[i] < 0 || indices[i] >= num_examples) return -1;
  }
  if (num_threads < 1) num_threads = 1;
  const int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  num_threads = static_cast<int>(
      std::min<int64_t>(num_threads, std::max<int64_t>(hw, 1)));
  // Below ~1 MiB of payload the thread spawn overhead dominates.
  if (num_indices * item_bytes < (1 << 20)) num_threads = 1;

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * item_bytes,
                  images + indices[i] * item_bytes,
                  static_cast<size_t>(item_bytes));
    }
  };
  if (num_threads == 1) {
    worker(0, num_indices);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  const int64_t chunk = (num_indices + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(lo + chunk, num_indices);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Same contract for int32 rows (labels gathered alongside images).
int gather_i32(const int32_t* src,
               int64_t num_examples,
               int64_t row_elems,
               const int64_t* indices,
               int64_t num_indices,
               int32_t* out,
               int num_threads) {
  return gather_u8(reinterpret_cast<const uint8_t*>(src), num_examples,
                   row_elems * static_cast<int64_t>(sizeof(int32_t)), indices,
                   num_indices, reinterpret_cast<uint8_t*>(out), num_threads);
}

// Same contract for int64 rows (the port's labels are int64, the dtype
// cross_entropy takes).
int gather_i64(const int64_t* src,
               int64_t num_examples,
               int64_t row_elems,
               const int64_t* indices,
               int64_t num_indices,
               int64_t* out,
               int num_threads) {
  return gather_u8(reinterpret_cast<const uint8_t*>(src), num_examples,
                   row_elems * static_cast<int64_t>(sizeof(int64_t)), indices,
                   num_indices, reinterpret_cast<uint8_t*>(out), num_threads);
}

}  // extern "C"
