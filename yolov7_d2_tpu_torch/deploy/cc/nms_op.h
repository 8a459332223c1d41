// The C++ registration of the op yolov7_d2_tpu_torch::nms_batched
// (nms_op.cpp), for the serving client (aoti_infer.cpp).
#pragma once

#include <cstdint>
#include <tuple>

#include <ATen/Tensor.h>

namespace yolo_cc {

// The op's schema, as kernels/nms.py defines it for Python processes.
inline constexpr const char* kNmsSchema =
    "nms_batched(Tensor boxes, Tensor scores, float iou_threshold, "
    "int max_outputs) -> (Tensor, Tensor)";

// Calls of the op (either body) and launches of the NMS kernel (the CUDA
// body), since the last reset.
int64_t nms_calls();
int64_t nms_launches();
void reset_nms_counts();

// The op through the dispatcher, as an AOTInductor package calls it.
std::tuple<at::Tensor, at::Tensor> call_nms(const at::Tensor& boxes,
                                            const at::Tensor& scores,
                                            double iou_threshold,
                                            int64_t max_outputs);

}  // namespace yolo_cc
