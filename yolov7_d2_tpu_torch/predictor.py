"""Serving entry point (JAX ``demo.py:21-88`` ``DefaultPredictor``).

``Predictor.predict_batch`` takes a letterboxed uint8 ``[B, H, W, 3]``
batch and returns ``Detections``: the normalize kernel, the model under its
compute dtype, and the tail with the NMS kernel. ``Predictor.__call__``
letterboxes one BGR image first with ``data/transforms/augment.letterbox``
(OpenCV, imported there only).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess
from yolov7_d2_tpu_torch.structures.instances import Detections


class Predictor:
    """YOLOX serving on ``device``; random weights from ``seed`` unless a
    built ``model`` is given. Another architecture raises: its outputs need
    their own tail (the anchor-YOLO family serves through ``build_model``
    and ``models/meta_arch/yolov7.anchor_yolo_postprocess``)."""

    def __init__(self, cfg: YoloxConfig = YoloxConfig(), device="cuda",
                 seed: int = 0, model: Optional[torch.nn.Module] = None):
        if cfg.meta_architecture != "YOLOX":
            raise NotImplementedError(
                f"Predictor serves YOLOX only, not "
                f"{cfg.meta_architecture!r}: serve the anchor-YOLO family "
                "with build_model + anchor_yolo_postprocess")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model if model is not None else build_model(
            cfg, self.device, seed)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw head outputs of a uint8 [B, H, W, 3] batch."""
        return self.model(images.to(self.device, non_blocking=True))

    @torch.inference_mode()
    def postprocess(self, head_out: Dict[str, torch.Tensor],
                    **kw) -> Detections:
        cfg = self.cfg
        return yolox_postprocess(
            head_out, conf_threshold=cfg.conf_threshold,
            nms_threshold=cfg.nms_threshold,
            max_detections=cfg.max_detections,
            pre_nms_topk=cfg.pre_nms_topk, **kw)

    def predict_batch(self, images: torch.Tensor) -> Detections:
        return self.postprocess(self.forward(images))

    def __call__(self, bgr_image: np.ndarray) -> Dict[str, np.ndarray]:
        from yolov7_d2_tpu_torch.data.transforms.augment import letterbox

        img, _, scale = letterbox(bgr_image, np.zeros((0, 4), np.float32),
                                  self.cfg.input_size, self.cfg.padded_value)
        dets = self.predict_batch(torch.from_numpy(img)[None])
        valid = dets.valid[0].cpu().numpy()
        return {
            "boxes": dets.boxes[0].cpu().numpy()[valid] / scale,
            "scores": dets.scores[0].cpu().numpy()[valid],
            "classes": dets.classes[0].cpu().numpy()[valid],
        }
