// Fused input normalize: uint8 NHWC -> (x - mean[c]) / std[c] -> bf16 or
// f32, written as the model's channels_last [B, 3, H, W] (NHWC memory).
//
// Replaces the TPU kernel
// yolov7_d2_tpu/ops/pallas_preprocess.py:_normalize_kernel (entry point
// fused_normalize), with the semantics of its plain twin
// reference_normalize: f32 subtract, IEEE f32 divide, one round to the
// output type (round to nearest even). The TPU kernel's lane fold and int8
// bitcast are layout tricks of that chip and have no counterpart here.
//
// Bound on the H100: memory. At B=128, 640x640 it reads 157 MB and writes
// 315 MB (bf16), about 0.14 ms at 3.35 TB/s. Design: one thread per 16
// pixels. It reads their 48 bytes with three 16-byte loads, and writes the
// 48 outputs, contiguous in channels_last memory, with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 16;  // pixels a thread

struct Stats {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4 packed[2];
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(packed);
#pragma unroll
  for (int q = 0; q < 16; ++q) h[q] = __float2bfloat16_rn(v[q]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = packed[0];
  d[1] = packed[1];
}

template <typename OutT>
__global__ void normalize_kernel(const uint8_t* __restrict__ in,
                                 OutT* __restrict__ out, int64_t groups,
                                 Stats st) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const uint4* src = reinterpret_cast<const uint4*>(in + g * (kPix * 3));
  uint4 raw[3] = {src[0], src[1], src[2]};
  const uint8_t* px = reinterpret_cast<const uint8_t*>(raw);
  float v[kPix * 3];
#pragma unroll
  for (int e = 0; e < kPix * 3; ++e) {
    const int c = e % 3;
    v[e] = __fdiv_rn(__fsub_rn(static_cast<float>(px[e]), st.mean[c]),
                     st.std[c]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) store16(out + g * (kPix * 3) + q * kPix,
                                      v + q * kPix);
}

template <typename OutT>
cudaError_t launch(const void* in, void* out, int64_t pixels, const Stats& st,
                   cudaStream_t stream) {
  const int64_t groups = pixels / kPix;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((groups + threads - 1) / threads);
  normalize_kernel<OutT><<<blocks, threads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<OutT*>(out), groups, st);
  return cudaGetLastError();
}

}  // namespace

// in: uint8 [B, H, W, 3] contiguous; out: channels_last [B, 3, H, W], bf16
// (out_bf16=1) or f32. pixels = B*H*W, a multiple of 16; both pointers
// 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int yolo_normalize_launch(const void* in, void* out,
                                     int64_t pixels, int out_bf16, float m0,
                                     float m1, float m2, float s0, float s1,
                                     float s2, void* stream) {
  if (pixels <= 0 || pixels % kPix != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Stats st = {{m0, m1, m2}, {s0, s1, s2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(in, out, pixels, st, s)
               : launch<float>(in, out, pixels, st, s);
  return static_cast<int>(err);
}
