// GridMask: zero a grid of bands in each image of an NHWC batch, from five
// int32 parameters an image (d, keep, off_y, off_x, mode):
//
//   drop = ((y + off_y) mod d < d - keep) | ((x + off_x) mod d < d - keep)
//   mask = mode == 1 ? !drop : drop
//   out  = mask ? 0 : in
//
// Replaces the TPU kernel
// yolov7_d2_tpu/ops/pallas_preprocess.py:_grid_mask_kernel (entry point
// pallas_grid_mask), with its semantics: "mod" is the floor modulo of
// jnp's "%", and a zeroed float element is +0.
//
// Bound on the H100: memory. Each element is read once and written once;
// at [16, 640, 640, 3] float32 that is 78.6 MB read and 78.6 MB written,
// 0.047 ms at 3.35 TB/s (0.012 ms for uint8). Design: one thread a 16-byte
// chunk of an image (4 float32 or 16 uint8 elements), one 16-byte load and
// one 16-byte store. The image is blockIdx.y, so a thread reads its image's
// five parameters once into registers. The (y, x) of the chunk's first
// element comes from its offset by one division each; the next elements
// step the channel, x and y counters, and the mask is recomputed only when
// the pixel changes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBytes = 16;  // bytes a thread

struct Params {
  int d, band, off_y, off_x, invert;
};

__device__ __forceinline__ int floor_mod(int a, int d) {
  const int r = a % d;
  return r < 0 ? r + d : r;
}

__device__ __forceinline__ bool zeroed(const Params& p, int y, int x) {
  const bool drop = floor_mod(y + p.off_y, p.d) < p.band ||
                    floor_mod(x + p.off_x, p.d) < p.band;
  return p.invert ? !drop : drop;
}

template <typename T>
__global__ void grid_mask_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 const int32_t* __restrict__ params, int w,
                                 int c, int64_t chunks) {
  constexpr int kElems = kBytes / sizeof(T);
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (chunk >= chunks) return;
  const int b = blockIdx.y;
  const int32_t* q = params + 5 * b;
  const Params p = {q[0], q[0] - q[1], q[2], q[3], q[4] == 1};

  const int64_t e0 = chunk * kElems;  // first element, within the image
  const int64_t pix = e0 / c;
  int ch = static_cast<int>(e0 - pix * c);
  int y = static_cast<int>(pix / w);
  int x = static_cast<int>(pix - static_cast<int64_t>(y) * w);

  const int64_t offset = static_cast<int64_t>(b) * chunks * kElems + e0;
  uint4 raw = *reinterpret_cast<const uint4*>(in + offset);
  T* v = reinterpret_cast<T*>(&raw);
  bool zero = zeroed(p, y, x);
#pragma unroll
  for (int i = 0; i < kElems; ++i) {
    if (zero) v[i] = T(0);
    if (++ch == c) {
      ch = 0;
      if (++x == w) {
        x = 0;
        ++y;
      }
      zero = zeroed(p, y, x);
    }
  }
  *reinterpret_cast<uint4*>(out + offset) = raw;
}

template <typename T>
cudaError_t launch(const void* in, void* out, const int32_t* params, int b,
                   int w, int c, int64_t chunks, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid(static_cast<unsigned int>((chunks + threads - 1) / threads),
                  static_cast<unsigned int>(b));
  grid_mask_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), params, w, c, chunks);
  return cudaGetLastError();
}

}  // namespace

// in, out: contiguous [B, H, W, C] of float32 (elem_bytes 4) or uint8
// (elem_bytes 1), 16-byte aligned, H*W*C*elem_bytes a multiple of 16, not
// overlapping. params: int32 [B, 5] on the card, d >= 1. Returns the
// cudaError_t of the launch.
extern "C" int yolo_grid_mask_launch(const void* in, void* out,
                                     const void* params, int b, int h, int w,
                                     int c, int elem_bytes, void* stream) {
  const int64_t image_bytes =
      static_cast<int64_t>(h) * w * c * elem_bytes;
  if (b <= 0 || b > 65535 || image_bytes <= 0 || image_bytes % kBytes != 0 ||
      (elem_bytes != 1 && elem_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunks = image_bytes / kBytes;
  const int32_t* p = static_cast<const int32_t*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      elem_bytes == 4 ? launch<float>(in, out, p, b, w, c, chunks, s)
                      : launch<uint8_t>(in, out, p, b, w, c, chunks, s);
  return static_cast<int>(err);
}
