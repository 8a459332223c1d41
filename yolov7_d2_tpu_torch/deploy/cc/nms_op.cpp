// The op yolov7_d2_tpu_torch::nms_batched in C++, for a process without
// Python: an AOTInductor package of a program with YOLOX's tail fused in
// calls the op through the dispatcher by name, and in the serving client
// (aoti_infer.cpp) this file defines it. Python processes keep the op of
// kernels/nms.py; the schema is the same text (nms_op.h), and the two
// definitions never meet in one process.
//
// CUDA body: the checks of kernels/nms.py `_launch`, then the NMS kernel
// (csrc/nms.cu `yolo_nms_launch`, compiled into the client as it is) on
// the current stream; it replaces the TPU kernel
// yolov7_d2_tpu/ops/pallas_nms.py:_nms_kernel. CPU body: kernels/nms.py
// `nms_batched_plain` with ops/iou.py `pairwise_box_iou`, the same ATen
// calls in the same order, so that its outputs are bitwise those of the
// Python version.

#include "nms_op.h"

#include <atomic>
#include <cstdint>

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/library.h>

#ifdef YOLO_CC_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int yolo_nms_launch(const void* boxes, const void* scores,
                               void* out_idx, void* out_valid, int batch,
                               int k, float thr, int max_out, void* stream);
#endif

namespace yolo_cc {
namespace {

constexpr double kNegInf = -1e10;  // kernels/nms.py NEG_INF
constexpr double kIouEps = 1e-9;   // ops/iou.py EPS
// one block of 1024 threads an image, one or two candidates a thread
constexpr int64_t kMaxBoxes = 2048;

std::atomic<int64_t> g_calls{0};
std::atomic<int64_t> g_launches{0};

// ops/iou.py pairwise_box_iou(a, a): a [B, N, 4] -> [B, N, N]
at::Tensor pairwise_box_iou(const at::Tensor& boxes) {
  const auto a = boxes.unsqueeze(-2).unbind(-1);  // a[..., :, None, :]
  const auto b = boxes.unsqueeze(-3).unbind(-1);  // b[..., None, :, :]
  const auto iw =
      at::clamp(at::minimum(a[2], b[2]) - at::maximum(a[0], b[0]), 0.0);
  const auto ih =
      at::clamp(at::minimum(a[3], b[3]) - at::maximum(a[1], b[1]), 0.0);
  const auto inter = iw * ih;
  const auto area_a =
      at::clamp(a[2] - a[0], 0.0) * at::clamp(a[3] - a[1], 0.0);
  const auto area_b =
      at::clamp(b[2] - b[0], 0.0) * at::clamp(b[3] - b[1], 0.0);
  return inter / (area_a + area_b - inter + kIouEps);
}

// kernels/nms.py nms_batched_plain
std::tuple<at::Tensor, at::Tensor> nms_cpu(const at::Tensor& boxes,
                                           const at::Tensor& scores,
                                           double iou_threshold,
                                           int64_t max_outputs) {
  ++g_calls;
  const int64_t b = boxes.size(0);
  const int64_t n = boxes.size(1);
  const auto iou = pairwise_box_iou(boxes);
  auto live = at::where(scores > 0.0, scores, at::full_like(scores, kNegInf));
  const auto ar = at::arange(n, boxes.options().dtype(at::kLong));
  const auto rows = at::arange(b, boxes.options().dtype(at::kLong));
  auto keep_idx =
      at::full({b, max_outputs}, -1, boxes.options().dtype(at::kInt));
  auto keep_valid =
      at::zeros({b, max_outputs}, boxes.options().dtype(at::kBool));
  for (int64_t i = 0; i < max_outputs; ++i) {
    const auto best = at::argmax(live, 1);  // first index on ties
    const auto ok = live.index({rows, best}) > kNegInf * 0.5;
    keep_idx.select(1, i).copy_(at::where(ok, best, -1).to(at::kInt));
    keep_valid.select(1, i).copy_(ok);
    const auto suppress = (iou.index({rows, best}) > iou_threshold) |
                          (ar.unsqueeze(0) == best.unsqueeze(1));
    live = at::where(ok.unsqueeze(1) & suppress, kNegInf, live);
  }
  return {keep_idx, keep_valid};
}

#ifdef YOLO_CC_CUDA
// kernels/nms.py _launch: one kernel launch for the batch
std::tuple<at::Tensor, at::Tensor> nms_cuda(const at::Tensor& boxes_in,
                                            const at::Tensor& scores_in,
                                            double iou_threshold,
                                            int64_t max_outputs) {
  ++g_calls;
  TORCH_CHECK_VALUE(scores_in.device() == boxes_in.device(),
                    "nms_batched: boxes on ", boxes_in.device(),
                    ", scores on ", scores_in.device());
  TORCH_CHECK_TYPE(boxes_in.scalar_type() == at::kFloat &&
                       scores_in.scalar_type() == at::kFloat,
                   "nms_batched: boxes and scores must be float32");
  TORCH_CHECK_VALUE(boxes_in.dim() == 3 && boxes_in.size(2) == 4 &&
                        scores_in.dim() == 2 &&
                        scores_in.size(0) == boxes_in.size(0) &&
                        scores_in.size(1) == boxes_in.size(1),
                    "nms_batched: shapes ", boxes_in.sizes(), ", ",
                    scores_in.sizes());
  const int64_t b = boxes_in.size(0);
  const int64_t n = boxes_in.size(1);
  TORCH_CHECK_VALUE(n > 0 && n <= kMaxBoxes, "nms_batched: ", n,
                    " candidates, the kernel takes 1..", kMaxBoxes);
  TORCH_CHECK_VALUE(b > 0 && max_outputs > 0,
                    "nms_batched: empty batch or max_outputs");
  // the kernel reads contiguous rows, the boxes as 16-byte vectors: a copy
  // of an input that is not so (the allocator aligns its blocks)
  auto boxes = boxes_in;
  if (!boxes.is_contiguous() ||
      reinterpret_cast<std::uintptr_t>(boxes.data_ptr()) % 16 != 0) {
    boxes = boxes_in.clone(at::MemoryFormat::Contiguous);
  }
  const auto scores = scores_in.contiguous();
  const c10::cuda::CUDAGuard guard(boxes.device());
  auto keep_idx =
      at::empty({b, max_outputs}, boxes.options().dtype(at::kInt));
  auto keep_valid =
      at::empty({b, max_outputs}, boxes.options().dtype(at::kBool));
  const auto stream = c10::cuda::getCurrentCUDAStream(boxes.device().index());
  const int err = yolo_nms_launch(
      boxes.data_ptr(), scores.data_ptr(), keep_idx.data_ptr(),
      keep_valid.data_ptr(), static_cast<int>(b), static_cast<int>(n),
      static_cast<float>(iou_threshold), static_cast<int>(max_outputs),
      stream.stream());
  TORCH_CHECK(err == 0, "nms kernel launch failed: cudaError_t ", err);
  ++g_launches;
  return {keep_idx, keep_valid};
}
#endif

}  // namespace

int64_t nms_calls() { return g_calls.load(); }
int64_t nms_launches() { return g_launches.load(); }

void reset_nms_counts() {
  g_calls = 0;
  g_launches = 0;
}

std::tuple<at::Tensor, at::Tensor> call_nms(const at::Tensor& boxes,
                                            const at::Tensor& scores,
                                            double iou_threshold,
                                            int64_t max_outputs) {
  static const auto op =
      c10::Dispatcher::singleton()
          .findSchemaOrThrow("yolov7_d2_tpu_torch::nms_batched", "")
          .typed<std::tuple<at::Tensor, at::Tensor>(
              const at::Tensor&, const at::Tensor&, double, int64_t)>();
  return op.call(boxes, scores, iou_threshold, max_outputs);
}

}  // namespace yolo_cc

TORCH_LIBRARY(yolov7_d2_tpu_torch, m) { m.def(yolo_cc::kNmsSchema); }

TORCH_LIBRARY_IMPL(yolov7_d2_tpu_torch, CPU, m) {
  m.impl("nms_batched", &yolo_cc::nms_cpu);
}

#ifdef YOLO_CC_CUDA
TORCH_LIBRARY_IMPL(yolov7_d2_tpu_torch, CUDA, m) {
  m.impl("nms_batched", &yolo_cc::nms_cuda);
}
#endif
