// Nearest-neighbour mask upsampling for the host-side mask drain (plain C
// ABI, loaded with ctypes by ops/native_upsample.py).
//
// The engines return feature-resolution uint8 masks (60x107 at 480p) and the
// host upsamples them to full resolution (ops/resize.py::nearest_resize_host).
// This is the numpy mapping's two gathers as one row-gather loop, threaded
// over frames. The index math is the same exact floor mapping
// (r_src = r * hd / H, clamped), so the bytes are the same; the loader
// checks that at first use and keeps numpy on any mismatch.
//
// Build (done at first use by ops/native_upsample.py, into build/host/):
//   g++ -O3 -shared -fPIC -o libsvosupsample.so upsample.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// src: (n, hd, wd) uint8 C-contiguous -> dst: (n, H, W) uint8.
// Returns 0 on success.
int svos_nearest_u8(const uint8_t* src, int64_t n, int hd, int wd,
                    uint8_t* dst, int H, int W, int max_threads) {
  if (n <= 0 || hd <= 0 || wd <= 0 || H <= 0 || W <= 0) return 1;

  // floor mapping, clamped — identical to the numpy twin
  std::vector<int32_t> rmap(H), cmap(W);
  for (int r = 0; r < H; ++r)
    rmap[r] = std::min<int32_t>((int64_t)r * hd / H, hd - 1);
  for (int c = 0; c < W; ++c)
    cmap[c] = std::min<int32_t>((int64_t)c * wd / W, wd - 1);

  // one expanded source row is reused for every output row mapping to it
  const size_t src_frame = (size_t)hd * wd;
  const size_t dst_frame = (size_t)H * W;

  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> rowbuf(W);
    for (int64_t f = lo; f < hi; ++f) {
      const uint8_t* s = src + f * src_frame;
      uint8_t* d = dst + f * dst_frame;
      int last_sr = -1;
      for (int r = 0; r < H; ++r) {
        const int sr = rmap[r];
        if (sr != last_sr) {
          const uint8_t* srow = s + (size_t)sr * wd;
          for (int c = 0; c < W; ++c) rowbuf[c] = srow[cmap[c]];
          last_sr = sr;
        }
        std::memcpy(d + (size_t)r * W, rowbuf.data(), W);
      }
    }
  };

  int nthreads = (int)std::min<int64_t>(
      n, std::max(1, std::min<int>(max_threads,
                                   std::thread::hardware_concurrency())));
  if (nthreads <= 1) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
