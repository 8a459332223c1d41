"""Dataset mappers: record dict -> fixed-shape training sample (copies from
``yolov7_d2_tpu/data/mappers.py``).

  * ``YOLOXDatasetMapper``: YOLOX mosaic from a stateful pool,
    ``random_perspective``, optional MixUp, HSV and flip, and an
    ``enable_aug`` switch that the trainer's ``AugDisableHook`` turns off
    at ``DISABLE_AT_ITER``.
  * ``SimpleDatasetMapper``: the config's augmentation chain, then the
    letterbox; the eval mapper; with ``with_masks`` the dense instance
    masks too, with ``MODEL.KEYPOINT_ON`` the keypoints (the YOLOX-KPTS
    feed).
  * ``DarknetMosaicDatasetMapper``: the Darknet blend mosaic from a record
    pool, the SparseInst feed.
  * ``DetrDatasetMapper``: flip and ``ResizeShortestEdge``, half the time
    with a small resize and ``RandomCrop`` before the last resize, the DETR
    family's feed.

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

# the COCO 17 keypoints' left <-> right permutation under a horizontal flip
# (nose, eyes, ears, shoulders, elbows, wrists, hips, knees, ankles)
COCO_KP_HFLIP_17 = np.asarray(
    [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15], np.int64
)


def keypoint_hflip_indices(num_keypoints: int) -> np.ndarray:
    """The flip permutation: COCO's for 17 keypoints, else the identity."""
    if num_keypoints == 17:
        return COCO_KP_HFLIP_17
    return np.arange(num_keypoints, dtype=np.int64)

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

    ``with_masks=True`` also rasterizes the polygon segmentations and
    carries them through the same geometry into dense ``gt_masks``
    ``[max_boxes, H, W]`` uint8 (the SparseInst feed).

    ``MODEL.KEYPOINT_ON`` carries each
    non-crowd annotation's ``keypoints`` (x, y, v) through every
    transform's ``apply_coords``: a horizontal flip also swaps the left
    and right identities (:func:`keypoint_hflip_indices`), the keypoints
    of dropped boxes go with them, a keypoint out of the frame turns
    invisible (v = 0, its x and y kept), and the letterbox scales them into
    ``gt_keypoints`` ``[max_boxes, P, 3]`` float32 (the YOLOX-KPTS
    feed)."""

    def __init__(self, cfg, is_train: bool = True, seed: int = 0,
                 with_masks: bool = False):
        from yolov7_d2_tpu_torch.data.detection_utils import build_augmentation

        self.is_train = is_train
        self.input_size = tuple(cfg.INPUT.INPUT_SIZE)
        self.max_boxes = cfg.MODEL.YOLO.MAX_BOXES_NUM
        self.pad_value = int(cfg.MODEL.PADDED_VALUE)
        self.with_masks = with_masks
        self.with_keypoints = bool(cfg.MODEL.KEYPOINT_ON)
        self.num_keypoints = int(cfg.MODEL.YOLO.KEYPOINTS_NUM)
        self.flip_prob = (
            cfg.INPUT.RANDOM_FLIP_HORIZONTAL.PROB
            if cfg.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED and is_train
            else 0.0
        )
        self.augmentations = build_augmentation(cfg, is_train)
        self.rng = np.random.default_rng(seed)

    def _rasterize_masks_raw(self, record: dict):
        """Per-instance [H0, W0] uint8 masks aligned with the non-crowd
        annotation order (same filter as annotations_to_arrays)."""
        from yolov7_d2_tpu_torch.evaluation.coco_eval import polygons_to_mask

        h0 = record.get("height")
        w0 = record.get("width")
        masks = []
        for ann in record.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            seg = ann.get("segmentation")
            if seg and isinstance(seg, list):
                m = polygons_to_mask(seg, h0, w0).astype(np.uint8)
            else:
                m = np.zeros((h0, w0), np.uint8)
            masks.append(m)
        return masks

    def _extract_keypoints(self, record: dict) -> np.ndarray:
        """[N, P, 3] keypoints in the order of the non-crowd annotations
        (the filter of :func:`annotations_to_arrays`); an annotation
        without them gets zeros."""
        p = self.num_keypoints
        rows = []
        for ann in record.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            k = np.asarray(
                ann.get("keypoints", [0.0] * (p * 3)), np.float32
            ).reshape(-1, 3)[:p]
            kk = np.zeros((p, 3), np.float32)
            kk[: len(k)] = k
            rows.append(kk)
        if rows:
            return np.stack(rows)
        return np.zeros((0, p, 3), np.float32)

    def _apply_augmentations(self, img, boxes, classes, masks=None,
                             kpts=None):
        """Run the cfg chain; returns transformed arrays (keypoints None
        where none are carried) plus the cumulative uniform resize scale
        (for eval coordinate bookkeeping)."""
        from yolov7_d2_tpu_torch.data.transforms.api import ResizeTransform

        pre_scale = 1.0
        for aug in self.augmentations:
            t = aug.get_transform(img, self.rng)
            img = t.apply_image(img)
            if len(boxes):
                boxes = t.apply_box(boxes)
            if masks is not None:
                masks = [t.apply_segmentation(m) for m in masks]
            if kpts is not None and len(kpts):
                kpts = kpts.copy()
                kpts[..., :2] = t.apply_coords(
                    kpts[..., :2].reshape(-1, 2).astype(np.float32)
                ).reshape(kpts.shape[0], -1, 2)
                if t.is_hflip:
                    kpts = kpts[:, keypoint_hflip_indices(self.num_keypoints)]
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
            if masks is not None:
                masks = [m for m, k in zip(masks, keep) if k]
            if kpts is not None and len(kpts):
                kpts = kpts[keep]
        if kpts is not None and len(kpts):
            # keypoints pushed out of the frame turn invisible
            kpts = kpts.copy()
            oob = ((kpts[..., 0] < 0) | (kpts[..., 0] >= w)
                   | (kpts[..., 1] < 0) | (kpts[..., 1] >= h))
            kpts[..., 2] = np.where(oob, 0.0, kpts[..., 2])
        return img, boxes, classes, masks, kpts, pre_scale

    def _finalize(
        self, record, img, boxes, classes, masks, kpts, pre_scale
    ) -> Dict[str, np.ndarray]:
        """Letterbox to the static shape and densify to [max_boxes]."""
        img, boxes, r = _letterbox_fast(
            img, boxes, self.input_size, self.pad_value
        )
        sample = densify(boxes, classes, self.max_boxes)
        th, tw = self.input_size
        if masks is not None:
            dense = np.zeros((self.max_boxes, th, tw), np.uint8)
            for i, m in enumerate(masks):
                if i >= self.max_boxes:
                    break
                nh = max(round(m.shape[0] * r), 1)
                nw = max(round(m.shape[1] * r), 1)
                rm = cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST)
                dense[i, : min(nh, th), : min(nw, tw)] = rm[
                    : min(nh, th), : min(nw, tw)
                ]
            sample["gt_masks"] = dense
        if kpts is not None:
            out = np.zeros((self.max_boxes, self.num_keypoints, 3),
                           np.float32)
            g = min(len(kpts), self.max_boxes)
            if g:
                kk = kpts[:g].copy()
                kk[..., :2] *= r
                out[:g] = kk
            sample["gt_keypoints"] = out
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
        masks = self._rasterize_masks_raw(record) if self.with_masks else None
        kpts = (self._extract_keypoints(record) if self.with_keypoints
                else None)
        img, boxes, classes, masks, kpts, pre_scale = (
            self._apply_augmentations(img, boxes, classes, masks, kpts))
        return self._finalize(record, img, boxes, classes, masks, kpts,
                              pre_scale)


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


class DarknetMosaicDatasetMapper(SimpleDatasetMapper):
    """Darknet-style cut-point blend mosaic with a stateful record pool
    (``MyDatasetMapper``): once the pool holds more than
    ``INPUT.MOSAIC.NUM_IMAGES`` records, a coin flip (50%) blends this
    record with ``NUM_IMAGES - 1`` drawn from the pool, each re-loaded and
    re-augmented through the config's chain, at a random cut point
    (``blend_mosaic4``). With ``with_masks=True`` this is the SparseInst
    feed (``train_inseg``)."""

    def __init__(self, cfg, is_train: bool = True, seed: int = 0,
                 with_masks: bool = False):
        super().__init__(cfg, is_train, seed, with_masks)
        mcfg = cfg.INPUT.MOSAIC
        self.mosaic_enabled = bool(mcfg.ENABLED) and is_train
        self.num_images = int(mcfg.NUM_IMAGES)
        self.min_offset = float(mcfg.MIN_OFFSET)
        self.mosaic_hw = (int(mcfg.MOSAIC_HEIGHT), int(mcfg.MOSAIC_WIDTH))
        self.pool: deque = deque(maxlen=mcfg.POOL_CAPACITY)
        # late-training aug disable switch (AugDisableHook)
        self.enable_aug = True

    def _load_tile(self, record: dict):
        img = read_image_bgr(record["file_name"])
        boxes, classes = annotations_to_arrays(record)
        masks = self._rasterize_masks_raw(record) if self.with_masks else None
        img, boxes, classes, masks, _, _ = self._apply_augmentations(
            img, boxes, classes, masks
        )
        return img, boxes, classes, masks

    def __call__(self, record: dict) -> Dict[str, np.ndarray]:
        if not (self.mosaic_enabled and self.enable_aug):
            return super().__call__(record)

        do_mosaic = (
            len(self.pool) > self.num_images
            and int(self.rng.integers(2)) == 1
        )
        samples = None
        if do_mosaic:
            idxs = self.rng.choice(
                len(self.pool), self.num_images - 1, replace=True
            )
            samples = [self.pool[int(i)] for i in idxs]
        self.pool.append(record)
        if not do_mosaic:
            return super().__call__(record)

        tiles = [self._load_tile(r) for r in [record] + samples]
        img, boxes, classes, masks = A.blend_mosaic4(
            tiles, self.mosaic_hw, self.min_offset, self.rng
        )
        return self._finalize(record, img, boxes, classes, masks, None, 1.0)


class DetrDatasetMapper(SimpleDatasetMapper):
    """The DETR family's mapper (JAX :423, reference dataset_mapper.py:
    804-884): flip and ``ResizeShortestEdge``; where ``INPUT.CROP.ENABLED``
    (training), half the time (``rng.random() > 0.5`` keeps the plain
    chain) ``ResizeShortestEdge([400, 500, 600], 10000)`` and
    ``RandomCrop`` go in before the last resize. Then the letterbox to
    ``INPUT_SIZE``."""

    def __init__(self, cfg, is_train: bool = True, seed: int = 0):
        from yolov7_d2_tpu_torch.data.transforms.api import (
            RandomCrop,
            RandomFlip,
            ResizeShortestEdge,
        )

        super().__init__(cfg, is_train, seed)
        if is_train:
            self.tfm_gens = [
                RandomFlip(cfg.INPUT.RANDOM_FLIP_HORIZONTAL.PROB),
                ResizeShortestEdge(
                    cfg.INPUT.MIN_SIZE_TRAIN,
                    cfg.INPUT.MAX_SIZE_TRAIN,
                    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING,
                ),
            ]
        else:
            self.tfm_gens = [
                ResizeShortestEdge(
                    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
                )
            ]
        self.crop_gen = None
        if cfg.INPUT.CROP.ENABLED and is_train:
            self.crop_gen = [
                ResizeShortestEdge([400, 500, 600], 10_000, "choice"),
                RandomCrop(cfg.INPUT.CROP.TYPE, cfg.INPUT.CROP.SIZE),
            ]

    def __call__(self, record: dict) -> Dict[str, np.ndarray]:
        if self.crop_gen is None or self.rng.random() > 0.5:
            self.augmentations = self.tfm_gens
        else:
            self.augmentations = (
                self.tfm_gens[:-1] + self.crop_gen + self.tfm_gens[-1:]
            )
        img = read_image_bgr(record["file_name"])
        boxes, classes = annotations_to_arrays(record)
        img, boxes, classes, _, _, pre_scale = self._apply_augmentations(
            img, boxes, classes
        )
        return self._finalize(record, img, boxes, classes, None, None,
                              pre_scale)


class MapperFactory:
    """A picklable ``mapper_factory(worker_id)`` for the spawned workers of
    ``data/mp_loader.py`` (JAX :502): worker ``i`` builds
    ``mapper_cls(cfg, is_train, seed=i, **kw)``. A closure over ``cfg``
    cannot cross the spawn boundary."""

    def __init__(self, mapper_cls, cfg, is_train: bool = True, **kw):
        self.mapper_cls = mapper_cls
        self.cfg = cfg.clone()
        self.is_train = is_train
        self.kw = kw

    def __call__(self, worker_id: int):
        return self.mapper_cls(self.cfg, is_train=self.is_train,
                               seed=worker_id, **self.kw)
