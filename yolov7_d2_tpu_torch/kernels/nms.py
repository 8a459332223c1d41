"""Greedy hard NMS over a batch: the CUDA kernel (``csrc/nms.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``yolov7_d2_tpu/ops/pallas_nms.py:_nms_kernel``;
the semantics are those of ``yolov7_d2_tpu/ops/nms.py:nms_batched``.
``nms_batched`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. The kernel has two instances, of 1024 and of
2048 candidates an image (Mask R-CNN's RPN gives 1280); the launcher takes
the smallest that holds N.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yolov7_d2_tpu_torch.kernels import build
from yolov7_d2_tpu_torch.ops.iou import pairwise_box_iou

NEG_INF = -1e10
# one block of 1024 threads an image, one or two candidates a thread
# (csrc/nms.cu)
MAX_BOXES = 2048


def nms_batched_plain(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
    max_outputs: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [B, N, 4] xyxy, scores [B, N] (0 = padded slot) ->
    (keep_idx [B, max_outputs] int32 with -1 padding, keep_valid bool)."""
    b, n, _ = boxes.shape
    iou = pairwise_box_iou(boxes, boxes)  # [B, N, N]
    live = torch.where(scores > 0.0, scores,
                       torch.full_like(scores, NEG_INF))
    ar = torch.arange(n, device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    keep_idx = torch.full((b, max_outputs), -1, dtype=torch.int32,
                          device=boxes.device)
    keep_valid = torch.zeros((b, max_outputs), dtype=torch.bool,
                             device=boxes.device)
    for i in range(max_outputs):
        best = torch.argmax(live, dim=1)  # first index on ties
        ok = live[rows, best] > NEG_INF * 0.5
        keep_idx[:, i] = torch.where(ok, best, -1).to(torch.int32)
        keep_valid[:, i] = ok
        suppress = (iou[rows, best] > iou_threshold) | (ar[None] == best[:, None])
        live = torch.where(ok[:, None] & suppress, NEG_INF, live)
    return keep_idx, keep_valid


def nms_batched(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
    max_outputs: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`nms_batched_plain`; one kernel launch for the
    batch on a CUDA tensor."""
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return nms_batched_plain(boxes, scores, iou_threshold, max_outputs)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(
            f"nms_batched: boxes on {boxes.device}, scores on {scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_batched: boxes and scores must be float32")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_batched: shapes {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_batched: inputs must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_batched: boxes must be 16-byte aligned")
    b, n, _ = boxes.shape
    if not 0 < n <= MAX_BOXES:
        raise ValueError(f"nms_batched: {n} candidates, the kernel takes "
                         f"1..{MAX_BOXES}")
    if b == 0 or max_outputs <= 0:
        raise ValueError("nms_batched: empty batch or max_outputs")
    lib = build.load_library()
    keep_idx = torch.empty((b, max_outputs), dtype=torch.int32,
                           device=boxes.device)
    keep_valid = torch.empty((b, max_outputs), dtype=torch.bool,
                             device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.yolo_nms_launch(
        boxes.data_ptr(), scores.data_ptr(), keep_idx.data_ptr(),
        keep_valid.data_ptr(), b, n, float(iou_threshold), max_outputs,
        stream)
    build.check(err, "nms")
    # a count an instance: "nms" (1024), "nms_2048" (Mask R-CNN's RPN)
    build.LAUNCHES["nms" if n <= MAX_BOXES // 2 else "nms_2048"] += 1
    return keep_idx, keep_valid
