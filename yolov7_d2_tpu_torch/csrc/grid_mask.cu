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
// one 16-byte store, so a uint8 thread moves only 32 bytes and its index
// arithmetic, not the memory, would set the pace if it were heavy. So the
// arithmetic is in 32 bits (an image holds fewer than 2^31 elements; only
// the batch offset is 64-bit), and a thread divides a constant number of
// times: two divisions find the (y, x) of the chunk's first element, and
// three floor modulos the band counters (y + off_y) mod d, (x + off_x) mod d
// and, for the start of the next row, off_x mod d. The walk over the chunk's
// pixels (about 5 for uint8 with C = 3; a chunk may cross a row) steps those
// counters with a wrap and no division, and marks the zeroed elements in a
// 16-bit mask, which then clears the chunk's words with AND.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBytes = 16;  // bytes a thread

__device__ __forceinline__ int floor_mod(int a, int d) {
  const int r = a % d;
  return r < 0 ? r + d : r;
}

// The bits of 32-bit word `word` of a chunk to clear, from the chunk's
// element mask (bit i: element i is zeroed).
template <typename T>
__device__ __forceinline__ uint32_t word_clear(uint32_t bits, int word);

template <>
__device__ __forceinline__ uint32_t word_clear<float>(uint32_t bits,
                                                      int word) {
  return 0u - ((bits >> word) & 1u);
}

template <>
__device__ __forceinline__ uint32_t word_clear<uint8_t>(uint32_t bits,
                                                        int word) {
  // four mask bits -> four bytes of 0x00 or 0xff: the product puts bit j at
  // bit 8j (the shifted copies do not overlap, so nothing carries)
  const uint32_t nibble = (bits >> (4 * word)) & 0xfu;
  return ((nibble * 0x00204081u) & 0x01010101u) * 0xffu;
}

template <typename T>
__global__ void grid_mask_kernel(const uint4* __restrict__ in,
                                 uint4* __restrict__ out,
                                 const int32_t* __restrict__ params, int w,
                                 int c, int chunks) {
  constexpr int kElems = kBytes / sizeof(T);
  const int chunk = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunk >= chunks) return;
  const int b = blockIdx.y;
  const size_t at = static_cast<size_t>(b) * chunks + chunk;
  uint4 v = in[at];  // in flight while the mask is worked out
  const int32_t* q = params + 5 * b;
  const int d = q[0];
  const int band = q[0] - q[1];
  const bool invert = q[4] == 1;

  const int e0 = chunk * kElems;  // first element, within the image
  const int pix = e0 / c;
  const int y = pix / w;
  int x = pix - y * w;
  int start = pix * c - e0;  // first element of pixel `pix`, from the chunk
  int ry = floor_mod(y + q[2], d);
  int rx = floor_mod(x + q[3], d);
  const int rx_row = floor_mod(q[3], d);  // rx at x = 0
  bool drop_y = ry < band;

  uint32_t bits = 0;
  for (;;) {
    const bool last = c >= kElems - start;  // the pixel ends the chunk
    if ((drop_y || rx < band) != invert) {
      const int lo = max(start, 0);
      const int hi = last ? kElems : start + c;
      bits |= ((1u << hi) - 1u) & ~((1u << lo) - 1u);
    }
    if (last) break;
    start += c;
    if (++x == w) {
      x = 0;
      rx = rx_row;
      if (++ry == d) ry = 0;
      drop_y = ry < band;
    } else if (++rx == d) {
      rx = 0;
    }
  }
  v.x &= ~word_clear<T>(bits, 0);
  v.y &= ~word_clear<T>(bits, 1);
  v.z &= ~word_clear<T>(bits, 2);
  v.w &= ~word_clear<T>(bits, 3);
  out[at] = v;
}

template <typename T>
cudaError_t launch(const void* in, void* out, const int32_t* params, int b,
                   int w, int c, int chunks, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid(static_cast<unsigned int>((chunks + threads - 1) / threads),
                  static_cast<unsigned int>(b));
  grid_mask_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), params, w, c,
      chunks);
  return cudaGetLastError();
}

}  // namespace

// in, out: contiguous [B, H, W, C] of float32 (elem_bytes 4) or uint8
// (elem_bytes 1), 16-byte aligned, H*W*C*elem_bytes a multiple of 16 and
// below 2^31, not overlapping. params: int32 [B, 5] on the card, d >= 1.
// Returns the cudaError_t of the launch.
extern "C" int yolo_grid_mask_launch(const void* in, void* out,
                                     const void* params, int b, int h, int w,
                                     int c, int elem_bytes, void* stream) {
  const int64_t image_bytes =
      static_cast<int64_t>(h) * w * c * elem_bytes;
  if (b <= 0 || b > 65535 || image_bytes <= 0 || image_bytes % kBytes != 0 ||
      image_bytes >= (int64_t{1} << 31) ||
      (elem_bytes != 1 && elem_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = static_cast<int>(image_bytes / kBytes);
  const int32_t* p = static_cast<const int32_t*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      elem_bytes == 4 ? launch<float>(in, out, p, b, w, c, chunks, s)
                      : launch<uint8_t>(in, out, p, b, w, c, chunks, s);
  return static_cast<int>(err);
}
