// Threaded row-gather and float32 -> bfloat16 cast for the host data path
// (dualvgr_tpu_torch/data/native.py).
//
// The RAM-cached FeatureStore assembles each training batch by gathering
// feature rows (flagship appearance batch: 256 rows x 2 MB = 0.5 GB per
// step) straight into the pinned batch tensor. This splits the rows across
// std::threads, each issuing straight memcpys: the loader's num_workers
// (reference DataLoader.py:163) become threads, without pickling or
// process forks.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread _gather.cpp -o _gather.so
// (done at first use by native.py, into dualvgr_tpu_torch/_build/; a
// failed build raises there).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Copy rows[i]-th row of src (n_src rows x row_bytes) into dst row i.
// Returns 0 on success, -1 on an out-of-range row index.
int gather_rows(const char* src, int64_t n_src, int64_t row_bytes,
                const int64_t* rows, int64_t n_out, char* dst,
                int n_threads) {
  for (int64_t i = 0; i < n_out; ++i) {
    if (rows[i] < 0 || rows[i] >= n_src) return -1;
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_out) n_threads = static_cast<int>(n_out);

  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      std::memcpy(dst + i * row_bytes, src + rows[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };

  if (n_threads == 1) {
    worker(0, n_out);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n_out + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < n_out ? begin + chunk : n_out;
    if (begin >= end) break;
    threads.emplace_back(worker, begin, end);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

// Round-to-nearest-even float32 -> bfloat16 cast (bit pattern out), split
// across threads. Used by FeatureStore's bfloat16 transfer path: casting
// host-side halves the bytes shipped over PCIe/DMA per batch (the flagship
// appearance batch drops 537 MB -> 268 MB) and halves the RAM cache. The
// rounding matches ml_dtypes/XLA exactly: RNE on finite values (carry may
// round up to inf), NaN keeps its sign and is quieted.
static inline uint16_t f32_bits_to_bf16(uint32_t x) {
  if ((x & 0x7fffffffu) > 0x7f800000u) {  // NaN: quiet it, keep the sign
    return static_cast<uint16_t>((x >> 16) | 0x0040u);
  }
  uint32_t lsb = (x >> 16) & 1u;
  return static_cast<uint16_t>((x + 0x7fffu + lsb) >> 16);
}

extern "C" {

int cast_f32_bf16(const float* src, uint16_t* dst, int64_t n, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n > 0 ? n : 1);

  auto worker = [&](int64_t begin, int64_t end) {
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
    for (int64_t i = begin; i < end; ++i) dst[i] = f32_bits_to_bf16(bits[i]);
  };

  if (n_threads == 1) {
    worker(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    threads.emplace_back(worker, begin, end);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
