// Greedy class-aware hard NMS for a batch of images, one launch.
//
// Replaces the TPU kernel yolov7_d2_tpu/ops/pallas_nms.py:_nms_kernel
// (entry points pallas_nms / pallas_batched_nms) with the batched
// semantics of yolov7_d2_tpu/ops/nms.py:nms_batched on class-offset boxes:
//   live = score if score > 0 else -1e10
//   repeat max_out times:
//     best = argmax(live), the lowest index on ties
//     if live[best] <= -5e9: write idx -1, valid 0
//     else: write idx best, valid 1; kill best and every box with
//           IoU(best, box) > thr, IoU = inter / (area_a + area_b - inter + 1e-9)
//
// Bound on the H100: latency. The loop is max_out dependent block-wide
// argmax reductions over K <= 1024 candidates; the data (16 KB a image) is
// read once. Design: one CTA per image, one thread per candidate. Each
// thread keeps its box, area and live score in registers; the coordinates
// also sit in shared memory so that every thread can read the winner's box.
// The argmax is a warp-shuffle reduction and then one across warps, two
// __syncthreads an iteration. Its comparison orders (score, -index)
// lexicographically, so the result does not depend on the order of the
// reduction and ties go to the lower index, as XLA's argmax and the Pallas
// kernel do. Every product, sum and quotient of the IoU is a single IEEE
// round-to-nearest operation (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn):
// nvcc would otherwise contract area + area - inter into an FMA, whose
// different rounding flips IoU-at-threshold decisions against the plain
// PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e10f;
constexpr float kDeadBelow = -5e9f;  // NEG_INF * 0.5 in ops/nms.py
constexpr float kEps = 1e-9f;
constexpr int kMaxBoxes = 1024;

__device__ __forceinline__ bool better(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float box_area(float x0, float y0, float x1,
                                          float y1) {
  return __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.f),
                   fmaxf(__fsub_rn(y1, y0), 0.f));
}

__global__ void nms_kernel(const float* __restrict__ boxes,   // [B, K, 4]
                           const float* __restrict__ scores,  // [B, K]
                           int k, float thr, int max_out,
                           int* __restrict__ out_idx,          // [B, max_out]
                           unsigned char* __restrict__ out_valid) {
  extern __shared__ float smem[];  // x0[k], y0[k], x1[k], y1[k]
  float* sx0 = smem;
  float* sy0 = smem + k;
  float* sx1 = smem + 2 * k;
  float* sy1 = smem + 3 * k;
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];
  __shared__ float best_val;
  __shared__ int best_idx;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* bb = boxes + static_cast<size_t>(b) * k * 4;
  int* oidx = out_idx + static_cast<size_t>(b) * max_out;
  unsigned char* ovalid = out_valid + static_cast<size_t>(b) * max_out;

  float x0 = 0.f, y0 = 0.f, x1 = 0.f, y1 = 0.f, live = kNegInf;
  if (t < k) {
    const float4 box = reinterpret_cast<const float4*>(bb)[t];
    x0 = box.x;
    y0 = box.y;
    x1 = box.z;
    y1 = box.w;
    sx0[t] = x0;
    sy0[t] = y0;
    sx1[t] = x1;
    sy1[t] = y1;
    const float s = scores[static_cast<size_t>(b) * k + t];
    live = s > 0.f ? s : kNegInf;
  }
  const float area = box_area(x0, y0, x1, y1);
  __syncthreads();

  for (int it = 0; it < max_out; ++it) {
    float v = live;
    int i = t;
    warp_argmax(v, i);
    if (lane == 0) {
      warp_val[warp] = v;
      warp_idx[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? warp_val[lane] : kNegInf;
      i = lane < nwarps ? warp_idx[lane] : 0x7fffffff;
      warp_argmax(v, i);
      if (lane == 0) {
        best_val = v;
        best_idx = i;
      }
    }
    __syncthreads();
    const int best = best_idx;
    if (!(best_val > kDeadBelow)) {
      // nothing left alive: this and every later slot is padding
      for (int j = it + t; j < max_out; j += blockDim.x) {
        oidx[j] = -1;
        ovalid[j] = 0;
      }
      return;
    }
    if (t == 0) {
      oidx[it] = best;
      ovalid[it] = 1;
    }
    const float bx0 = sx0[best], by0 = sy0[best];
    const float bx1 = sx1[best], by1 = sy1[best];
    const float barea = box_area(bx0, by0, bx1, by1);
    const float iw =
        fmaxf(__fsub_rn(fminf(bx1, x1), fmaxf(bx0, x0)), 0.f);
    const float ih =
        fmaxf(__fsub_rn(fminf(by1, y1), fmaxf(by0, y0)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float denom =
        __fadd_rn(__fsub_rn(__fadd_rn(barea, area), inter), kEps);
    const float iou = __fdiv_rn(inter, denom);
    if (iou > thr || t == best) live = kNegInf;
  }
}

}  // namespace

// boxes f32 [B, K, 4] (16-byte aligned), scores f32 [B, K]; writes
// out_idx int32 [B, max_out] and out_valid uint8 [B, max_out].
// Returns the cudaError_t of the launch.
extern "C" int yolo_nms_launch(const void* boxes, const void* scores,
                               void* out_idx, void* out_valid, int batch,
                               int k, float thr, int max_out, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxBoxes || max_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((k + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(4) * k * sizeof(float);
  nms_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores), k,
      thr, max_out, static_cast<int*>(out_idx),
      static_cast<unsigned char*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
