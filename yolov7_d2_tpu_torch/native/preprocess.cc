// Host-side letterbox of the port's data feed: bilinear resize of an HWC
// uint8 image into the top-left corner of a canvas filled with a gray value,
// one image or a batch over std::threads, no other dependencies. A copy of
// yolov7_d2_tpu/native/preprocess.cc (letterbox_u8, letterbox_batch_u8), so
// that the port's mappers give the JAX package's samples.
// Python binds it through ctypes (native/__init__.py), which compiles it at
// first use into build/native/ at the repository root.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear resize of an HWC uint8 image (C=3) into a sub-rectangle of the
// output canvas. Matches cv2.INTER_LINEAR geometry (half-pixel centers).
void resize_bilinear_into(const uint8_t* src, int sh, int sw,
                          uint8_t* dst, int dst_stride_row,
                          int nh, int nw) {
  const float sy = static_cast<float>(sh) / nh;
  const float sx = static_cast<float>(sw) / nw;
  for (int y = 0; y < nh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    uint8_t* out_row = dst + y * dst_stride_row;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
    for (int x = 0; x < nw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      for (int c = 0; c < 3; ++c) {
        float v00 = row0[x0 * 3 + c], v01 = row0[x1 * 3 + c];
        float v10 = row1[x0 * 3 + c], v11 = row1[x1 * 3 + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        out_row[x * 3 + c] =
            static_cast<uint8_t>(std::lround(top + (bot - top) * wy));
      }
    }
  }
}

}  // namespace

extern "C" {

// Letterbox one image: keep aspect, resize into the top-left corner of a
// (th, tw) canvas filled with pad_value. Returns the resize scale.
float letterbox_u8(const uint8_t* src, int sh, int sw,
                   uint8_t* dst, int th, int tw, uint8_t pad_value) {
  const float r = std::min(static_cast<float>(th) / sh,
                           static_cast<float>(tw) / sw);
  const int nh = std::max(1, static_cast<int>(std::lround(sh * r)));
  const int nw = std::max(1, static_cast<int>(std::lround(sw * r)));
  std::memset(dst, pad_value, static_cast<size_t>(th) * tw * 3);
  resize_bilinear_into(src, sh, sw, dst, tw * 3, nh, nw);
  return r;
}

// Batch letterbox: N images -> one [N, th, tw, 3] uint8 buffer, the images
// taken in turn by num_threads host threads. srcs: N pointers; shapes: N
// (h, w) pairs; scales_out: N.
void letterbox_batch_u8(const uint8_t** srcs, const int* shapes, int n,
                        uint8_t* dst, int th, int tw, uint8_t pad_value,
                        float* scales_out, int num_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      scales_out[i] = letterbox_u8(
          srcs[i], shapes[i * 2], shapes[i * 2 + 1],
          dst + static_cast<size_t>(i) * th * tw * 3, th, tw, pad_value);
    }
  };
  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
