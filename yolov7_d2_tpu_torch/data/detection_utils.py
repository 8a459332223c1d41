"""Config-driven augmentation chain (a copy of
``yolov7_d2_tpu/data/detection_utils.py``): the ``INPUT.*`` keys select
which augmentations run.

  * normal path (``INPUT.RESIZE.ENABLED`` False): ResizeShortestEdge, H/V
    flip, saturation/brightness jitter, HSV distortion, GridMask
  * yolov7 path (``INPUT.RESIZE.ENABLED`` True): ResizeShortestEdge,
    JitterCrop, forced Resize with scale jitter (when mosaic is on),
    distortion, GridMask, color jitter, flips
  * ``INPUT.SHIFT`` appends RandomShift to either path

Returns a list of ``Augmentation`` samplers (``transforms/api.py``).
"""

from __future__ import annotations

from typing import List

from yolov7_d2_tpu_torch.data.transforms.api import (
    Augmentation,
    ForcedResize,
    JitterCrop,
    RandomBrightness,
    RandomDistortion,
    RandomFlip,
    RandomGridMask,
    RandomSaturation,
    RandomShift,
    ResizeShortestEdge,
)


def _normal_augmentation(cfg, is_train: bool) -> List[Augmentation]:
    if is_train:
        min_size = cfg.INPUT.MIN_SIZE_TRAIN
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        sample_style = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
    else:
        min_size = cfg.INPUT.MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
        sample_style = "choice"
    augs: List[Augmentation] = [
        ResizeShortestEdge(min_size, max_size, sample_style)
    ]
    if not is_train:
        return augs
    if cfg.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED:
        augs.append(
            RandomFlip(cfg.INPUT.RANDOM_FLIP_HORIZONTAL.PROB, horizontal=True)
        )
    if cfg.INPUT.RANDOM_FLIP_VERTICAL.ENABLED:
        augs.append(
            RandomFlip(
                cfg.INPUT.RANDOM_FLIP_VERTICAL.PROB,
                horizontal=False, vertical=True,
            )
        )
    if cfg.INPUT.COLOR_JITTER.SATURATION:
        augs.append(RandomSaturation(0.8, 1.2))
    if cfg.INPUT.COLOR_JITTER.BRIGHTNESS:
        augs.append(RandomBrightness(0.8, 1.2))
    if cfg.INPUT.DISTORTION.ENABLED:
        augs.append(
            RandomDistortion(
                cfg.INPUT.DISTORTION.HUE,
                cfg.INPUT.DISTORTION.SATURATION,
                cfg.INPUT.DISTORTION.EXPOSURE,
            )
        )
    if cfg.INPUT.GRID_MASK.ENABLED:
        augs.append(
            RandomGridMask(
                prob=cfg.INPUT.GRID_MASK.PROB,
                use_h=cfg.INPUT.GRID_MASK.USE_HEIGHT,
                use_w=cfg.INPUT.GRID_MASK.USE_WIDTH,
                mode=cfg.INPUT.GRID_MASK.MODE,
            )
        )
    return augs


def _yolov7_augmentation(cfg, is_train: bool) -> List[Augmentation]:
    if not is_train:
        return [
            ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
        ]
    augs: List[Augmentation] = [
        ResizeShortestEdge(
            cfg.INPUT.MIN_SIZE_TRAIN,
            cfg.INPUT.MAX_SIZE_TRAIN,
            cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING,
        )
    ]
    if cfg.INPUT.JITTER_CROP.ENABLED:
        augs.append(JitterCrop(cfg.INPUT.JITTER_CROP.JITTER_RATIO))
    if cfg.INPUT.MOSAIC.ENABLED:
        augs.append(
            ForcedResize(
                shape=cfg.INPUT.RESIZE.SHAPE,
                scale_jitter=cfg.INPUT.RESIZE.SCALE_JITTER,
            )
        )
    if cfg.INPUT.DISTORTION.ENABLED:
        augs.append(
            RandomDistortion(
                cfg.INPUT.DISTORTION.HUE,
                cfg.INPUT.DISTORTION.SATURATION,
                cfg.INPUT.DISTORTION.EXPOSURE,
            )
        )
    if cfg.INPUT.GRID_MASK.ENABLED:
        augs.append(
            RandomGridMask(
                prob=cfg.INPUT.GRID_MASK.PROB,
                use_h=cfg.INPUT.GRID_MASK.USE_HEIGHT,
                use_w=cfg.INPUT.GRID_MASK.USE_WIDTH,
                mode=cfg.INPUT.GRID_MASK.MODE,
            )
        )
    if cfg.INPUT.COLOR_JITTER.SATURATION:
        augs.append(RandomSaturation(0.8, 1.2))
    if cfg.INPUT.COLOR_JITTER.BRIGHTNESS:
        augs.append(RandomBrightness(0.8, 1.2))
    if cfg.INPUT.RANDOM_FLIP_HORIZONTAL.ENABLED:
        augs.append(
            RandomFlip(cfg.INPUT.RANDOM_FLIP_HORIZONTAL.PROB, horizontal=True)
        )
    if cfg.INPUT.RANDOM_FLIP_VERTICAL.ENABLED:
        augs.append(
            RandomFlip(
                cfg.INPUT.RANDOM_FLIP_VERTICAL.PROB,
                horizontal=False, vertical=True,
            )
        )
    return augs


def build_augmentation(cfg, is_train: bool) -> List[Augmentation]:
    """The reference's exact selection logic (detection_utils.py:18-34)."""
    if not cfg.INPUT.RESIZE.ENABLED:
        augs = _normal_augmentation(cfg, is_train)
    else:
        augs = _yolov7_augmentation(cfg, is_train)
    if is_train and cfg.INPUT.SHIFT.ENABLED and cfg.INPUT.SHIFT.SHIFT_PIXELS > 0:
        augs.append(RandomShift(max_shifts=cfg.INPUT.SHIFT.SHIFT_PIXELS))
    return augs

