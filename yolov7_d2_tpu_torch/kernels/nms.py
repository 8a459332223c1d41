"""Greedy hard NMS over a batch: the CUDA kernel (``csrc/nms.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``yolov7_d2_tpu/ops/pallas_nms.py:_nms_kernel``;
the semantics are those of ``yolov7_d2_tpu/ops/nms.py:nms_batched``.
The kernel has two instances, of 1024 and of 2048 candidates an image
(Mask R-CNN's RPN gives 1280); the launcher takes the smallest that holds
N.

Both are one PyTorch custom op, ``yolov7_d2_tpu_torch::nms_batched``
(:data:`OP`), so that ``torch.export`` keeps the NMS in an exported graph
(the kernel is reached through ``ctypes``, which the tracer cannot see):
its CUDA body launches the kernel (copying inputs that are not contiguous
or not 16-byte aligned first) or raises, its CPU body is the plain
version, and its fake body gives the output shapes. ``nms_batched`` calls
the op; importing this module registers it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yolov7_d2_tpu_torch.kernels import build

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
    # here, not at the top: the ops package imports this module
    from yolov7_d2_tpu_torch.ops.iou import pairwise_box_iou

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


def _launch(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float, max_outputs: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's CUDA body: one kernel launch for the batch."""
    if scores.device != boxes.device:
        raise ValueError(
            f"nms_batched: boxes on {boxes.device}, scores on {scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_batched: boxes and scores must be float32")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_batched: shapes {tuple(boxes.shape)}, "
                         f"{tuple(scores.shape)}")
    b, n, _ = boxes.shape
    if not 0 < n <= MAX_BOXES:
        raise ValueError(f"nms_batched: {n} candidates, the kernel takes "
                         f"1..{MAX_BOXES}")
    if b == 0 or max_outputs <= 0:
        raise ValueError("nms_batched: empty batch or max_outputs")
    # the kernel reads contiguous rows, the boxes as 16-byte vectors: a
    # copy of an input that is not so (the allocator aligns its blocks)
    if not boxes.is_contiguous() or boxes.data_ptr() % 16:
        boxes = boxes.clone(memory_format=torch.contiguous_format)
    if not scores.is_contiguous():
        scores = scores.contiguous()
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


OP = "yolov7_d2_tpu_torch::nms_batched"
# the op's schema; the native client defines the same text in C++
# (deploy/cc/nms_op.h kNmsSchema)
SCHEMA = ("(Tensor boxes, Tensor scores, float iou_threshold, "
          "int max_outputs) -> (Tensor, Tensor)")


@torch.library.custom_op(OP, mutates_args=(), device_types="cpu",
                         schema=SCHEMA)
def _nms_op(boxes, scores, iou_threshold, max_outputs):
    """The op's CPU body: the plain version."""
    return nms_batched_plain(boxes, scores, iou_threshold, max_outputs)


_nms_op.register_kernel("cuda")(_launch)


@_nms_op.register_fake
def _nms_fake(boxes, scores, iou_threshold, max_outputs):
    b = boxes.shape[0]
    return (boxes.new_empty((b, max_outputs), dtype=torch.int32),
            boxes.new_empty((b, max_outputs), dtype=torch.bool))


def nms_batched(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
    max_outputs: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`nms_batched_plain`, through the op
    :data:`OP`: one kernel launch for the batch on CUDA tensors, the plain
    version on CPU tensors; inside ``torch.export`` one node of the
    graph. The outputs carry no gradient."""
    devices = {boxes.device.type, scores.device.type}
    if not devices <= {"cpu", "cuda"}:
        raise ValueError(f"nms_batched: boxes on {boxes.device}, scores on "
                         f"{scores.device}")
    return torch.ops.yolov7_d2_tpu_torch.nms_batched(
        boxes.detach(), scores.detach(), float(iou_threshold),
        int(max_outputs))
