"""Drawing detections, masks, keypoints and a mapper's annotations with
cv2 (a copy of ``yolov7_d2_tpu/utils/visualizer.py``): the same colours
from the same seed, so that both packages draw the same pixels.
``vis_annos`` draws a mapper output sample (the ``INPUT.MOSAIC.DEBUG_VIS``
hook).
"""

from __future__ import annotations

from typing import Optional, Sequence

import cv2
import numpy as np

_COLORS = np.random.default_rng(3).integers(60, 255, (256, 3))

# COCO skeleton (pairs of keypoint indices)
COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]


def draw_detections(
    image_bgr: np.ndarray,
    boxes: np.ndarray,
    scores: Optional[np.ndarray] = None,
    classes: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    thickness: int = 2,
) -> np.ndarray:
    img = image_bgr.copy()
    for i, box in enumerate(boxes):
        x0, y0, x1, y1 = [int(v) for v in box[:4]]
        cls = int(classes[i]) if classes is not None else 0
        color = tuple(int(c) for c in _COLORS[cls % 256])
        cv2.rectangle(img, (x0, y0), (x1, y1), color, thickness)
        label = class_names[cls] if class_names else str(cls)
        if scores is not None:
            label += f" {float(scores[i]):.2f}"
        cv2.putText(img, label, (x0, max(y0 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


def draw_masks(
    image_bgr: np.ndarray,
    masks: np.ndarray,          # [N, H, W] float or bool
    alpha: float = 0.45,
    threshold: float = 0.5,
) -> np.ndarray:
    img = image_bgr.astype(np.float32)
    h, w = img.shape[:2]
    for i, m in enumerate(masks):
        if m.shape != (h, w):
            m = cv2.resize(
                m.astype(np.float32), (w, h),
                interpolation=cv2.INTER_LINEAR,
            )
        binm = (m > threshold).astype(np.float32)[..., None]
        color = _COLORS[i % 256].astype(np.float32)
        img = img * (1 - alpha * binm) + color * alpha * binm
    return img.astype(np.uint8)


def draw_keypoints(
    image_bgr: np.ndarray,
    keypoints: np.ndarray,      # [N, P, 3]
    vis_threshold: float = 0.3,
    radius: int = 3,
) -> np.ndarray:
    img = image_bgr.copy()
    for inst in keypoints:
        for a, b in COCO_SKELETON:
            if a < len(inst) and b < len(inst):
                if inst[a, 2] > vis_threshold and inst[b, 2] > vis_threshold:
                    cv2.line(
                        img,
                        (int(inst[a, 0]), int(inst[a, 1])),
                        (int(inst[b, 0]), int(inst[b, 1])),
                        (90, 200, 90), 2,
                    )
        for p in inst:
            if p[2] > vis_threshold:
                cv2.circle(img, (int(p[0]), int(p[1])), radius,
                           (0, 120, 255), -1)
    return img


def vis_annos(sample: dict) -> np.ndarray:
    """Visualize a mapper output sample (the DEBUG_VIS hook,
    detection_utils.py:223 counterpart)."""
    img = sample["image"].astype(np.uint8)
    valid = sample["gt_valid"]
    img = draw_detections(
        img, sample["gt_boxes"][valid], classes=sample["gt_classes"][valid]
    )
    if "gt_masks" in sample:
        img = draw_masks(img, sample["gt_masks"][valid])
    return img
