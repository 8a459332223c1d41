"""Weights & Biases writers (a copy of
``yolov7_d2_tpu/utils/wandb_logger.py``): ``WandbWriter`` logs the
trainer's scalars, ``WandbInferenceLogger`` an image's detections as box
overlays. Each is a no-op where wandb does not import or its run does
not start.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("yolov7_d2_tpu_torch")


def _try_import_wandb():
    try:
        import wandb  # type: ignore

        return wandb
    except ImportError:
        return None


class WandbWriter:
    """EventStorage -> wandb.log writer (fixes the reference's missing
    symbol; drop-in for the PeriodicWriter hook)."""

    def __init__(self, project: str = "yolov7_d2_tpu", period: int = 20,
                 config: Optional[dict] = None):
        self.period = period
        self._wandb = _try_import_wandb()
        if self._wandb is not None:
            try:
                self._run = self._wandb.init(project=project, config=config)
            except Exception as e:  # offline/zero-egress
                logger.warning(f"wandb init failed ({e}); writer disabled")
                self._wandb = None

    def write(self, storage) -> None:
        if self._wandb is None or storage.iter % self.period != 0:
            return
        self._wandb.log(storage.latest(), step=storage.iter)


class WandbInferenceLogger:
    """Log per-image predictions as wandb.Image overlays
    (reference WandbInferenceLogger:148; used from demo.py:215-225)."""

    def __init__(self, project: str = "yolov7_d2_tpu-infer",
                 class_names=None):
        self._wandb = _try_import_wandb()
        self.class_names = class_names or []
        if self._wandb is not None:
            try:
                self._run = self._wandb.init(project=project)
            except Exception:
                self._wandb = None

    def log_image(self, image_bgr, boxes, scores, classes) -> None:
        if self._wandb is None:
            return
        box_data = [
            {
                "position": {
                    "minX": float(b[0]), "minY": float(b[1]),
                    "maxX": float(b[2]), "maxY": float(b[3]),
                },
                "domain": "pixel",
                "class_id": int(c),
                "scores": {"conf": float(s)},
            }
            for b, s, c in zip(boxes, scores, classes)
        ]
        img = self._wandb.Image(
            image_bgr[..., ::-1],
            boxes={"predictions": {"box_data": box_data}},
        )
        self._wandb.log({"inference": img})
