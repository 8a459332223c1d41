"""Dataset mappers: record dict -> fixed-shape training sample (copies from
``yolov7_d2_tpu/data/mappers.py``).

  * ``YOLOXDatasetMapper``: YOLOX mosaic from a stateful pool,
    ``random_perspective``, optional MixUp, HSV and flip, and an
    ``enable_aug`` switch that the trainer's ``AugDisableHook`` turns off
    at ``DISABLE_AT_ITER``.
  * ``SimpleDatasetMapper``: the config's augmentation chain, then the
    letterbox; the eval mapper.

Samples have static shapes: the image letterboxed to ``INPUT.INPUT_SIZE``
(float32 0..255), the labels densified to ``MAX_BOXES_NUM`` slots with a
validity mask. The letterbox of ``SimpleDatasetMapper`` is the native one
(``native/``) when it built, else cv2's, the JAX package's own choice; the
two differ by up to one grey level on some pixels.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import cv2
import numpy as np

from yolov7_d2_tpu_torch.data.transforms import augment as A
from yolov7_d2_tpu_torch.structures.boxes import BoxMode

from yolov7_d2_tpu_torch import native as _native

# native C++ letterbox (native/) when the toolchain built it; resolved, and
# the library built, at the first letterbox
_NATIVE: Optional[bool] = None


def _letterbox_fast(img, boxes, size, pad_value):
    """Native multithread-friendly letterbox with cv2 fallback."""
    global _NATIVE
    if _NATIVE is None:
        _NATIVE = _native.native_available()
    if _NATIVE and img.dtype == np.uint8:
        out, scale = _native.letterbox_u8(img, size, pad_value)
        if len(boxes):
            boxes = boxes.astype(np.float32) * scale
        return out, boxes, scale
    return A.letterbox(img, boxes, size, pad_value)


def read_image_bgr(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return img


def annotations_to_arrays(record: dict):
    """Extract xyxy boxes + classes from a dataset dict."""
    boxes, classes = [], []
    for ann in record.get("annotations", []):
        if ann.get("iscrowd", 0):
            continue
        bbox = np.asarray(ann["bbox"], np.float32)
        mode = ann.get("bbox_mode", int(BoxMode.XYWH_CORNER_ABS))
        if mode == int(BoxMode.XYWH_CORNER_ABS):
            bbox = np.array(
                [bbox[0], bbox[1], bbox[0] + bbox[2], bbox[1] + bbox[3]],
                np.float32,
            )
        elif mode == int(BoxMode.XYWH_ABS):  # center convention (quirk)
            bbox = np.array(
                [
                    bbox[0] - bbox[2] / 2, bbox[1] - bbox[3] / 2,
                    bbox[0] + bbox[2] / 2, bbox[1] + bbox[3] / 2,
                ],
                np.float32,
            )
        boxes.append(bbox)
        classes.append(ann["category_id"])
    if boxes:
        return np.stack(boxes), np.asarray(classes, np.int64)
    return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)


def densify(
    boxes: np.ndarray, classes: np.ndarray, max_boxes: int
) -> Dict[str, np.ndarray]:
    g = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_classes = np.zeros((max_boxes,), np.int32)
    out_valid = np.zeros((max_boxes,), bool)
    if g:
        out_boxes[:g] = boxes[:g]
        out_classes[:g] = classes[:g]
        out_valid[:g] = True
    return {
        "gt_boxes": out_boxes, "gt_classes": out_classes, "gt_valid": out_valid,
    }


class SimpleDatasetMapper:
    """Config-driven augmentation chain + letterbox to the static input size.

    The chain is built by ``build_augmentation(cfg, is_train)``
    (data/detection_utils.py) — the counterpart of the reference's
    ``build_augmentation`` (ref detection_utils.py:18-155): every
    ``INPUT.*`` toggle (flips, color jitter, distortion, GridMask,
    jitter-crop, forced resize, shift) changes the emitted sample.

    Boxes only: the JAX mapper's mask and keypoint paths come with the
    families that train on them (SparseInst, SOLOv2, YOLOX-KPTS)."""

    def __init__(self, cfg, is_train: bool = True, seed: int = 0):
        from yolov7_d2_tpu_torch.data.detection_utils import build_augmentation

        if cfg.MODEL.KEYPOINT_ON:
            raise NotImplementedError(
                "keypoints come with YOLOX-KPTS (ROADMAP.md Queue A.7)")
        self.is_train = is_train
        self.input_size = tuple(cfg.INPUT.INPUT_SIZE)
        self.max_boxes = cfg.MODEL.YOLO.MAX_BOXES_NUM
        self.pad_value = int(cfg.MODEL.PADDED_VALUE)
        self.flip_prob = (
            cfg.INPUT.RANDOM_FLIP_HORIZONTAL.PROB
            if cfg.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED and is_train
            else 0.0
        )
        self.augmentations = build_augmentation(cfg, is_train)
        self.rng = np.random.default_rng(seed)

    def _apply_augmentations(self, img, boxes, classes):
        """Run the cfg chain; returns transformed arrays plus the cumulative
        uniform resize scale (for eval coordinate bookkeeping)."""
        from yolov7_d2_tpu_torch.data.transforms.api import ResizeTransform

        pre_scale = 1.0
        for aug in self.augmentations:
            t = aug.get_transform(img, self.rng)
            img = t.apply_image(img)
            if len(boxes):
                boxes = t.apply_box(boxes)
            if isinstance(t, ResizeTransform):
                pre_scale *= t.scale

        # clip boxes to the augmented image; drop degenerate instances
        h, w = img.shape[:2]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            keep = (boxes[:, 2] - boxes[:, 0] > 1) & (
                boxes[:, 3] - boxes[:, 1] > 1
            )
            boxes, classes = boxes[keep], classes[keep]
        return img, boxes, classes, pre_scale

    def _finalize(
        self, record, img, boxes, classes, pre_scale
    ) -> Dict[str, np.ndarray]:
        """Letterbox to the static shape and densify to [max_boxes]."""
        img, boxes, r = _letterbox_fast(
            img, boxes, self.input_size, self.pad_value
        )
        sample = densify(boxes, classes, self.max_boxes)
        sample["image"] = np.ascontiguousarray(img, np.float32)
        sample["image_id"] = np.asarray(record.get("image_id", 0), np.int64)
        sample["scale"] = np.asarray(pre_scale * r, np.float32)
        sample["orig_hw"] = np.asarray(
            [record.get("height", img.shape[0]), record.get("width", img.shape[1])],
            np.int32,
        )
        return sample

    def __call__(self, record: dict) -> Dict[str, np.ndarray]:
        img = read_image_bgr(record["file_name"])
        boxes, classes = annotations_to_arrays(record)
        img, boxes, classes, pre_scale = self._apply_augmentations(
            img, boxes, classes
        )
        return self._finalize(record, img, boxes, classes, pre_scale)


class YOLOXDatasetMapper(SimpleDatasetMapper):
    """Mosaic + random_perspective + MixUp + HSV (MyDatasetMapper2)."""

    def __init__(self, cfg, is_train: bool = True, seed: int = 0):
        super().__init__(cfg, is_train, seed)
        mcfg = cfg.INPUT.MOSAIC_AND_MIXUP
        self.mosaic_enabled = bool(mcfg.ENABLED) and is_train
        self.enable_mixup = bool(mcfg.ENABLE_MIXUP)
        self.degrees = mcfg.DEGREES
        self.translate = mcfg.TRANSLATE
        self.scale = tuple(mcfg.SCALE)
        self.shear = mcfg.SHEAR
        self.perspective = mcfg.PERSPECTIVE
        self.wrange = tuple(mcfg.MOSAIC_WIDTH_RANGE)
        self.hrange = tuple(mcfg.MOSAIC_HEIGHT_RANGE)
        self.pool: deque = deque(maxlen=mcfg.POOL_CAPACITY)
        self.distortion = cfg.INPUT.DISTORTION.ENABLED
        self.hue = cfg.INPUT.DISTORTION.HUE
        self.saturation = cfg.INPUT.DISTORTION.SATURATION
        self.exposure = cfg.INPUT.DISTORTION.EXPOSURE
        # late-training switch (DISABLE_AT_ITER; trainer flips this flag —
        # deterministic step function instead of a dist.broadcast)
        self.enable_aug = True

    def _load(self, record: dict):
        img = read_image_bgr(record["file_name"])
        boxes, classes = annotations_to_arrays(record)
        return img, boxes, classes

    def __call__(self, record: dict) -> Dict[str, np.ndarray]:
        if not (self.mosaic_enabled and self.enable_aug):
            return super().__call__(record)

        img, boxes, classes = self._load(record)
        self.pool.append((img, boxes, classes))

        if len(self.pool) >= 4:
            idxs = self.rng.choice(len(self.pool), 3, replace=False)
            others = [self.pool[int(i)] for i in idxs]
            tiles = [(img, boxes, classes)] + others
            ch = int(self.rng.integers(self.hrange[0] // 2, self.hrange[1] // 2 + 1))
            cw = int(self.rng.integers(self.wrange[0] // 2, self.wrange[1] // 2 + 1))
            img, boxes, classes = A.mosaic4(
                [t[0] for t in tiles],
                [t[1] for t in tiles],
                [t[2] for t in tiles],
                (ch, cw),
                self.rng,
            )
            img, boxes, classes = A.random_perspective(
                img, boxes, classes, self.rng,
                target_size=self.input_size,
                degrees=self.degrees, translate=self.translate,
                scale=self.scale, shear=self.shear,
                perspective=self.perspective,
            )
            if self.enable_mixup and len(self.pool) > 4 and self.rng.random() < 0.5:
                j = int(self.rng.integers(0, len(self.pool)))
                img_b, boxes_b, classes_b = self.pool[j]
                img, boxes, classes = A.mixup(
                    img, boxes, classes, img_b, boxes_b, classes_b, self.rng
                )

        if self.distortion:
            img = A.hsv_distort(
                img, self.rng, self.hue, self.saturation, self.exposure
            )
        if self.rng.random() < self.flip_prob:
            img, boxes = A.hflip(img, boxes)
        img, boxes, scale = A.letterbox(
            img, boxes, self.input_size, self.pad_value
        )
        sample = densify(boxes, classes, self.max_boxes)
        sample["image"] = np.ascontiguousarray(img, np.float32)
        sample["image_id"] = np.asarray(record.get("image_id", 0), np.int64)
        sample["scale"] = np.asarray(scale, np.float32)
        sample["orig_hw"] = np.asarray(
            [record.get("height", img.shape[0]), record.get("width", img.shape[1])],
            np.int32,
        )
        return sample

