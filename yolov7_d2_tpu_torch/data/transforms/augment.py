"""Host-side numpy/cv2 augmentations of the YOLOX feed (copies from
``yolov7_d2_tpu/data/transforms/augment.py``): letterbox, the horizontal
and vertical flips, the pixel shift, HSV distortion, GridMask, the jitter
crop, ``random_perspective`` with ``box_candidates_mask``, ``mosaic4`` and
``mixup``. Geometry is tracked on
boxes [N, 4] xyxy; randomness comes from an explicit
``np.random.Generator``. ``blend_mosaic4``, the Darknet cut-point mosaic of
the SparseInst feed, also carries instance masks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import cv2
import numpy as np


GRAY = 114


def letterbox(
    img: np.ndarray,
    boxes: np.ndarray,
    size: Tuple[int, int],
    pad_value: int = GRAY,
    scaleup: bool = True,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Resize keeping aspect then pad to ``size`` (h, w). Top-left anchored,
    matching the reference's ImageList-style padding. Returns
    (image, boxes, scale)."""
    h0, w0 = img.shape[:2]
    th, tw = size
    r = min(th / h0, tw / w0)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = round(h0 * r), round(w0 * r)
    if (nh, nw) != (h0, w0):
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((th, tw, img.shape[2]), pad_value, img.dtype)
    out[:nh, :nw] = img
    if len(boxes):
        boxes = boxes.astype(np.float32) * r
    return out, boxes, r


def hflip(img: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    w = img.shape[1]
    img = np.ascontiguousarray(img[:, ::-1])
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def vflip(img: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h = img.shape[0]
    img = np.ascontiguousarray(img[::-1])
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    return img, boxes


def random_shift(
    img: np.ndarray,
    boxes: np.ndarray,
    max_pixels: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel shift with gray padding (YOLOFShiftTransform, transform.py:341)."""
    dx = int(rng.integers(-max_pixels, max_pixels + 1))
    dy = int(rng.integers(-max_pixels, max_pixels + 1))
    h, w = img.shape[:2]
    out = np.full_like(img, GRAY)
    xs0, xs1 = max(dx, 0), min(w + dx, w)
    ys0, ys1 = max(dy, 0), min(h + dy, h)
    out[ys0:ys1, xs0:xs1] = img[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] + dx, 0, w)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] + dy, 0, h)
    return out, boxes


def hsv_distort(
    img: np.ndarray,
    rng: np.random.Generator,
    hue: float = 0.1,
    saturation: float = 1.5,
    exposure: float = 1.5,
) -> np.ndarray:
    """HSV jitter (YOLOFDistortTransform semantics). Expects BGR uint8."""

    def rand_scale(s: float) -> float:
        scale = rng.uniform(1.0, s)
        return scale if rng.random() < 0.5 else 1.0 / scale

    dhue = rng.uniform(-hue, hue)
    dsat = rand_scale(saturation)
    dexp = rand_scale(exposure)
    hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_BGR2HSV).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] + dhue * 180.0) % 180.0
    hsv[..., 1] = np.clip(hsv[..., 1] * dsat, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * dexp, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)


def grid_mask(
    img: np.ndarray,
    rng: np.random.Generator,
    use_h: bool = True,
    use_w: bool = True,
    ratio: float = 0.5,
    mode: int = 1,
) -> np.ndarray:
    """GridMask dropout (reference Grid, transform.py:33-97)."""
    h, w = img.shape[:2]
    d = int(rng.integers(2, max(min(h, w) // 4, 3)))
    keep = max(int(d * ratio + 0.5), 1)
    mask = np.ones((h, w), np.float32)
    off_y = int(rng.integers(0, d))
    off_x = int(rng.integers(0, d))
    if use_h:
        ys = (np.arange(h) + off_y) % d
        mask[ys < (d - keep)] = 0.0
    if use_w:
        xs = (np.arange(w) + off_x) % d
        mask[:, xs < (d - keep)] = 0.0
    if mode == 1:
        mask = 1.0 - mask  # keep grid cells, drop the rest
    return (img.astype(np.float32) * mask[..., None]).astype(img.dtype)


def jitter_crop(
    img: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    jitter_ratio: float,
    rng: np.random.Generator,
):
    """Random crop with jittered borders (YOLOFJitterCropTransform:142)."""
    h, w = img.shape[:2]
    dw = int(w * jitter_ratio)
    dh = int(h * jitter_ratio)
    pl = int(rng.integers(-dw, dw + 1))
    pr = int(rng.integers(-dw, dw + 1))
    pt = int(rng.integers(-dh, dh + 1))
    pb = int(rng.integers(-dh, dh + 1))
    x0, y0 = max(pl, 0), max(pt, 0)
    x1, y1 = w - max(pr, 0), h - max(pb, 0)
    if x1 - x0 < 8 or y1 - y0 < 8:
        return img, boxes, classes
    img = img[y0:y1, x0:x1]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - x0, 0, x1 - x0)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - y0, 0, y1 - y0)
        keep = box_candidates_mask(boxes)
        boxes, classes = boxes[keep], classes[keep]
    return img, boxes, classes


def box_candidates_mask(
    boxes: np.ndarray, min_wh: float = 2.0, max_ar: float = 20.0
) -> np.ndarray:
    """Filter degenerate boxes (reference box_candidates, data_augment.py:16)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    ar = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
    return (w > min_wh) & (h > min_wh) & (ar < max_ar)


def random_perspective(
    img: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    rng: np.random.Generator,
    target_size: Optional[Tuple[int, int]] = None,
    degrees: float = 10.0,
    translate: float = 0.1,
    scale: Tuple[float, float] = (0.5, 1.5),
    shear: float = 2.0,
    perspective: float = 0.0,
):
    """Affine/perspective warp with gray border; boxes tracked through the
    transform and filtered (reference random_perspective, data_augment.py:31).

    ``target_size`` (h, w) sets the output canvas (defaults to input size).
    """
    h, w = (target_size or img.shape[:2])

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(scale[0], scale[1])
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h

    M = T @ S @ R @ P @ C
    if perspective:
        img = cv2.warpPerspective(
            img, M, dsize=(w, h), borderValue=(GRAY, GRAY, GRAY)
        )
    else:
        img = cv2.warpAffine(
            img, M[:2], dsize=(w, h), borderValue=(GRAY, GRAY, GRAY)
        )

    n = len(boxes)
    if n:
        pts = np.ones((n * 4, 3))
        pts[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        pts = pts @ M.T
        if perspective:
            pts = (pts[:, :2] / pts[:, 2:3]).reshape(n, 8)
        else:
            pts = pts[:, :2].reshape(n, 8)
        xs = pts[:, [0, 2, 4, 6]]
        ys = pts[:, [1, 3, 5, 7]]
        warped = np.stack(
            [xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1
        ).astype(np.float32)
        warped[:, [0, 2]] = warped[:, [0, 2]].clip(0, w)
        warped[:, [1, 3]] = warped[:, [1, 3]].clip(0, h)
        keep = box_candidates_mask(warped)
        boxes, classes = warped[keep], classes[keep]
    return img, boxes, classes


def mosaic4(
    images,
    boxes_list,
    classes_list,
    canvas_hw: Tuple[int, int],
    rng: np.random.Generator,
):
    """Four-tile YOLOX-style mosaic (reference MyDatasetMapper2:523-597):
    random center on a 2x canvas, paste each image into its quadrant,
    shift its boxes accordingly."""
    ch, cw = canvas_hw
    canvas = np.full((ch * 2, cw * 2, 3), GRAY, np.uint8)
    yc = int(rng.uniform(0.5 * ch, 1.5 * ch))
    xc = int(rng.uniform(0.5 * cw, 1.5 * cw))
    out_boxes, out_classes = [], []

    for i, (img, bxs, cls) in enumerate(zip(images, boxes_list, classes_list)):
        h0, w0 = img.shape[:2]
        scale = min(1.0 * ch / h0, 1.0 * cw / w0)
        img = cv2.resize(
            img, (int(w0 * scale), int(h0 * scale)),
            interpolation=cv2.INTER_LINEAR,
        )
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a = max(xc - w, 0), max(yc - h, 0)
            x2a, y2a = xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top-right
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, cw * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(ch * 2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, cw * 2), min(ch * 2, yc + h)
            x1b, y1b = 0, 0
            x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(bxs):
            b = bxs.astype(np.float32) * scale
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            out_boxes.append(b)
            out_classes.append(cls)

    if out_boxes:
        boxes = np.concatenate(out_boxes)
        classes = np.concatenate(out_classes)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, cw * 2)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, ch * 2)
        keep = box_candidates_mask(boxes)
        boxes, classes = boxes[keep], classes[keep]
    else:
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int64)
    return canvas, boxes, classes


def mixup(
    img_a: np.ndarray,
    boxes_a: np.ndarray,
    classes_a: np.ndarray,
    img_b: np.ndarray,
    boxes_b: np.ndarray,
    classes_b: np.ndarray,
    rng: np.random.Generator,
    mixup_scale: Tuple[float, float] = (0.5, 1.5),
):
    """YOLOX MixUp (reference MyDatasetMapper2.mixup:686-767): jitter-resize
    the second image onto a gray canvas of the first's size, 0.5/0.5 blend,
    union labels."""
    h, w = img_a.shape[:2]
    jit = rng.uniform(mixup_scale[0], mixup_scale[1])
    flip = rng.random() < 0.5
    h0, w0 = img_b.shape[:2]
    r = min(h / h0, w / w0) * jit
    nh, nw = max(int(h0 * r), 1), max(int(w0 * r), 1)
    resized = cv2.resize(img_b, (nw, nh), interpolation=cv2.INTER_LINEAR)
    if flip:
        resized = resized[:, ::-1]
    canvas = np.full((h, w, 3), GRAY, np.uint8)
    ph, pw = min(nh, h), min(nw, w)
    canvas[:ph, :pw] = resized[:ph, :pw]
    mixed = (img_a.astype(np.float32) * 0.5 + canvas.astype(np.float32) * 0.5)

    if len(boxes_b):
        b = boxes_b.astype(np.float32) * r
        if flip:
            b[:, [0, 2]] = nw - b[:, [2, 0]]
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        keep = box_candidates_mask(b)
        boxes = np.concatenate([boxes_a, b[keep]]) if len(boxes_a) else b[keep]
        classes = (
            np.concatenate([classes_a, classes_b[keep]])
            if len(classes_a)
            else classes_b[keep]
        )
    else:
        boxes, classes = boxes_a, classes_a
    return mixed.astype(np.uint8), boxes, classes


def blend_mosaic4(
    tiles,
    canvas_hw: Tuple[int, int],
    min_offset: float,
    rng: np.random.Generator,
):
    """Darknet-style cut-point blend mosaic (the original reference's
    ``MyDatasetMapper._blend_moasic``; JAX ``augment.py:364``).

    A random cut point splits the canvas into 4 quadrants; each quadrant is
    filled from the corresponding window of one source image (with a random
    crop shift when the source is larger than the canvas). Boxes are
    translated, clipped to their quadrant, and degenerate remains dropped.

    ``tiles``: list of 4 ``(img, boxes, classes, masks_or_None)``;
    ``masks`` is a list of [H, W] uint8 arrays aligned with ``boxes``.
    Returns (canvas, boxes, classes, masks_list_or_None).
    """
    h, w = canvas_hw
    cut_x = int(rng.integers(int(w * min_offset), int(w * (1 - min_offset))))
    cut_y = int(rng.integers(int(h * min_offset), int(h * (1 - min_offset))))
    quads = [
        (0, 0, cut_x, cut_y),
        (cut_x, 0, w - cut_x, cut_y),
        (0, cut_y, cut_x, h - cut_y),
        (cut_x, cut_y, w - cut_x, h - cut_y),
    ]
    out = np.zeros((h, w, 3), np.uint8)
    out_boxes, out_classes, out_masks = [], [], []
    with_masks = tiles[0][3] is not None

    for (img, boxes, classes, masks), (qx, qy, qw, qh) in zip(tiles, quads):
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            # upsize so every quadrant window exists (the reference
            # guarantees this via the forced-resize aug before the mosaic)
            r = max(h / ih, w / iw)
            nh, nw = int(math.ceil(ih * r)), int(math.ceil(iw * r))
            img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
            if len(boxes):
                boxes = boxes.astype(np.float32) * r
            if with_masks:
                masks = [
                    cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST)
                    for m in masks
                ]
            ih, iw = nh, nw
        # source window: quadrant position plus random slack shift
        sx = qx + (int(rng.integers(0, iw - w + 1)) if iw > w else 0)
        sy = qy + (int(rng.integers(0, ih - h + 1)) if ih > h else 0)
        out[qy : qy + qh, qx : qx + qw] = img[sy : sy + qh, sx : sx + qw]

        if len(boxes):
            b = boxes.astype(np.float32).copy()
            b[:, [0, 2]] += qx - sx
            b[:, [1, 3]] += qy - sy
            b[:, [0, 2]] = b[:, [0, 2]].clip(qx, qx + qw)
            b[:, [1, 3]] = b[:, [1, 3]].clip(qy, qy + qh)
            keep = box_candidates_mask(b)
            out_boxes.append(b[keep])
            out_classes.append(classes[keep])
            if with_masks:
                for i in np.nonzero(keep)[0]:
                    mc = np.zeros((h, w), np.uint8)
                    mc[qy : qy + qh, qx : qx + qw] = masks[int(i)][
                        sy : sy + qh, sx : sx + qw
                    ]
                    out_masks.append(mc)

    if out_boxes:
        boxes = np.concatenate(out_boxes)
        classes = np.concatenate(out_classes)
    else:
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int64)
    return out, boxes, classes, (out_masks if with_masks else None)
