"""Deterministic transforms and the random augmentation samplers that make
them (copies from ``yolov7_d2_tpu/data/transforms/api.py``).

A ``Transform`` is the sampled, deterministic geometry or photometry op:
``apply_image(img)``, ``apply_coords(pts[N, 2])``,
``apply_box(boxes[N, 4] xyxy)`` and ``apply_segmentation(mask[H, W])``
(geometry only, nearest interpolation; photometric ops leave masks as they
are). An ``Augmentation`` samples from an
explicit ``np.random.Generator`` and returns a Transform:
``get_transform(img, rng) -> Transform``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import cv2
import numpy as np

from yolov7_d2_tpu_torch.data.transforms import augment as A


GRAY = A.GRAY


class Transform:
    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return img

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        return coords

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        if len(boxes) == 0:
            return boxes
        corners = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(-1, 2)
        c = self.apply_coords(corners.astype(np.float32)).reshape(-1, 4, 2)
        return np.concatenate([c.min(axis=1), c.max(axis=1)], axis=1)

    def apply_segmentation(self, mask: np.ndarray) -> np.ndarray:
        return mask

    # a transform that mirrors x says so: the mapper then swaps the left
    # and right keypoints' identities
    is_hflip: bool = False


class NoOpTransform(Transform):
    pass


class HFlipTransform(Transform):
    is_hflip = True

    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords

    def apply_segmentation(self, mask):
        return np.ascontiguousarray(mask[:, ::-1])


class VFlipTransform(Transform):
    def __init__(self, height: int):
        self.height = height

    def apply_image(self, img):
        return np.ascontiguousarray(img[::-1])

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 1] = self.height - coords[:, 1]
        return coords

    def apply_segmentation(self, mask):
        return np.ascontiguousarray(mask[::-1])


class ResizeTransform(Transform):
    def __init__(self, h0: int, w0: int, h1: int, w1: int):
        self.h0, self.w0, self.h1, self.w1 = h0, w0, h1, w1

    @property
    def scale(self) -> float:
        """Uniform scale when aspect is (approximately) kept — used by eval
        bookkeeping to map predictions back to original pixels."""
        return self.h1 / max(self.h0, 1)

    def apply_image(self, img):
        return cv2.resize(img, (self.w1, self.h1), interpolation=cv2.INTER_LINEAR)

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] *= self.w1 / self.w0
        coords[:, 1] *= self.h1 / self.h0
        return coords

    def apply_segmentation(self, mask):
        return cv2.resize(mask, (self.w1, self.h1),
                          interpolation=cv2.INTER_NEAREST)


class CropTransform(Transform):
    def __init__(self, x0: int, y0: int, w: int, h: int):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h

    def apply_image(self, img):
        return img[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w]

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords

    def apply_box(self, boxes):
        out = super().apply_box(boxes)
        if len(out):
            out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0, self.w)
            out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0, self.h)
        return out

    def apply_segmentation(self, mask):
        return self.apply_image(mask)


class PadTransform(Transform):
    """Pad to (h, w) with a fill value, top-left anchored."""

    def __init__(self, h: int, w: int, fill: int = GRAY):
        self.h, self.w, self.fill = h, w, fill

    def apply_image(self, img):
        out_shape = (self.h, self.w) + img.shape[2:]
        out = np.full(out_shape, self.fill, img.dtype)
        out[: img.shape[0], : img.shape[1]] = img
        return out

    def apply_segmentation(self, mask):
        out = np.zeros((self.h, self.w), mask.dtype)
        out[: mask.shape[0], : mask.shape[1]] = mask
        return out


class ShiftTransform(Transform):
    """Pixel shift, gray fill (YOLOFShiftTransform, ref transform.py:341)."""

    def __init__(self, dx: int, dy: int):
        self.dx, self.dy = dx, dy

    def apply_image(self, img):
        h, w = img.shape[:2]
        fill = GRAY if img.ndim == 3 else 0
        out = np.full_like(img, fill)
        xs0, xs1 = max(self.dx, 0), min(w + self.dx, w)
        ys0, ys1 = max(self.dy, 0), min(h + self.dy, h)
        out[ys0:ys1, xs0:xs1] = img[
            ys0 - self.dy : ys1 - self.dy, xs0 - self.dx : xs1 - self.dx
        ]
        return out

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] += self.dx
        coords[:, 1] += self.dy
        return coords

    def apply_segmentation(self, mask):
        return self.apply_image(mask)


class PhotometricTransform(Transform):
    """Image-only transform (color/masking); geometry untouched."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn

    def apply_image(self, img):
        return self.fn(img)


class TransformList(Transform):
    """Several transforms applied in order, as one."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_box(self, boxes):
        for t in self.transforms:
            boxes = t.apply_box(boxes)
        return boxes

    def apply_segmentation(self, mask):
        for t in self.transforms:
            mask = t.apply_segmentation(mask)
        return mask


class Augmentation:
    def get_transform(self, img: np.ndarray, rng: np.random.Generator) -> Transform:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class ResizeShortestEdge(Augmentation):
    """d2 T.ResizeShortestEdge semantics: scale so the short edge matches a
    sampled min_size, capped so the long edge <= max_size."""

    def __init__(self, min_sizes, max_size: int, sample_style: str = "choice"):
        if isinstance(min_sizes, int):
            min_sizes = [min_sizes]
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.sample_style = sample_style

    def get_transform(self, img, rng):
        h, w = img.shape[:2]
        if self.sample_style == "range":
            size = int(rng.integers(min(self.min_sizes), max(self.min_sizes) + 1))
        else:
            size = int(self.min_sizes[int(rng.integers(len(self.min_sizes)))])
        if size == 0:
            return NoOpTransform()
        scale = size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if (nh, nw) == (h, w):
            return NoOpTransform()
        return ResizeTransform(h, w, nh, nw)


class RandomFlip(Augmentation):
    def __init__(self, prob: float = 0.5, horizontal: bool = True,
                 vertical: bool = False):
        self.prob = prob
        self.horizontal = horizontal
        self.vertical = vertical

    def get_transform(self, img, rng):
        if rng.random() >= self.prob:
            return NoOpTransform()
        if self.horizontal:
            return HFlipTransform(img.shape[1])
        if self.vertical:
            return VFlipTransform(img.shape[0])
        return NoOpTransform()


class RandomSaturation(Augmentation):
    """d2 semantics: blend with the grayscale image by a random factor."""

    def __init__(self, lo: float = 0.8, hi: float = 1.2):
        self.lo, self.hi = lo, hi

    def get_transform(self, img, rng):
        f = float(rng.uniform(self.lo, self.hi))

        def fn(im):
            gray = cv2.cvtColor(im.astype(np.uint8), cv2.COLOR_BGR2GRAY)
            out = gray[..., None].astype(np.float32) * (1 - f) + im.astype(
                np.float32
            ) * f
            return np.clip(out, 0, 255).astype(im.dtype)

        return PhotometricTransform(fn)


class RandomBrightness(Augmentation):
    def __init__(self, lo: float = 0.8, hi: float = 1.2):
        self.lo, self.hi = lo, hi

    def get_transform(self, img, rng):
        f = float(rng.uniform(self.lo, self.hi))
        return PhotometricTransform(
            lambda im: np.clip(im.astype(np.float32) * f, 0, 255).astype(im.dtype)
        )


class RandomDistortion(Augmentation):
    """HSV distortion (YOLOFRandomDistortion, ref augmentation_impl.py:115)."""

    def __init__(self, hue: float, saturation: float, exposure: float):
        self.hue, self.saturation, self.exposure = hue, saturation, exposure

    def get_transform(self, img, rng):
        # sample NOW so the transform is deterministic
        seed = int(rng.integers(0, 2**31))
        return PhotometricTransform(
            lambda im: A.hsv_distort(
                im, np.random.default_rng(seed),
                self.hue, self.saturation, self.exposure,
            )
        )


class RandomGridMask(Augmentation):
    """GridMask dropout (RandomGridMask, ref augmentation_impl.py:29)."""

    def __init__(self, prob: float = 0.3, use_h: bool = True,
                 use_w: bool = True, mode: int = 1):
        self.prob, self.use_h, self.use_w, self.mode = prob, use_h, use_w, mode

    def get_transform(self, img, rng):
        if rng.random() >= self.prob:
            return NoOpTransform()
        seed = int(rng.integers(0, 2**31))
        return PhotometricTransform(
            lambda im: A.grid_mask(
                im, np.random.default_rng(seed),
                use_h=self.use_h, use_w=self.use_w, mode=self.mode,
            )
        )


class JitterCrop(Augmentation):
    """Random border crop (YOLOFJitterCrop, ref augmentation_impl.py:55)."""

    def __init__(self, jitter_ratio: float):
        self.jitter_ratio = jitter_ratio

    def get_transform(self, img, rng):
        h, w = img.shape[:2]
        dw = int(w * self.jitter_ratio)
        dh = int(h * self.jitter_ratio)
        pl = int(rng.integers(-dw, dw + 1))
        pr = int(rng.integers(-dw, dw + 1))
        pt = int(rng.integers(-dh, dh + 1))
        pb = int(rng.integers(-dh, dh + 1))
        x0, y0 = max(pl, 0), max(pt, 0)
        x1, y1 = w - max(pr, 0), h - max(pb, 0)
        if x1 - x0 < 8 or y1 - y0 < 8:
            return NoOpTransform()
        return CropTransform(x0, y0, x1 - x0, y1 - y0)


class ForcedResize(Augmentation):
    """Resize to a fixed shape with optional scale jitter
    (YOLOFResize, ref augmentation_impl.py:78)."""

    def __init__(self, shape, scale_jitter: Optional[Tuple[float, float]] = None):
        self.shape = tuple(shape)  # (h, w)
        self.scale_jitter = tuple(scale_jitter) if scale_jitter else None

    def get_transform(self, img, rng):
        h, w = img.shape[:2]
        th, tw = self.shape
        if self.scale_jitter is not None:
            j = float(rng.uniform(*self.scale_jitter))
            th, tw = int(th * j), int(tw * j)
        return ResizeTransform(h, w, max(th, 1), max(tw, 1))


class RandomShift(Augmentation):
    """YOLOFRandomShift (ref augmentation_impl.py:168)."""

    def __init__(self, max_shifts: int):
        self.max_shifts = max_shifts

    def get_transform(self, img, rng):
        dx = int(rng.integers(-self.max_shifts, self.max_shifts + 1))
        dy = int(rng.integers(-self.max_shifts, self.max_shifts + 1))
        return ShiftTransform(dx, dy)


class RandomCrop(Augmentation):
    """d2 T.RandomCrop: crop a random window of relative/absolute size."""

    def __init__(self, crop_type: str, crop_size):
        self.crop_type = crop_type
        self.crop_size = tuple(crop_size)

    def get_transform(self, img, rng):
        h, w = img.shape[:2]
        if self.crop_type == "relative_range":
            ch_r = float(rng.uniform(self.crop_size[0], 1.0))
            cw_r = float(rng.uniform(self.crop_size[1], 1.0))
            ch, cw = int(h * ch_r + 0.5), int(w * cw_r + 0.5)
        elif self.crop_type == "relative":
            ch = int(h * self.crop_size[0] + 0.5)
            cw = int(w * self.crop_size[1] + 0.5)
        else:  # absolute
            ch = min(int(self.crop_size[0]), h)
            cw = min(int(self.crop_size[1]), w)
        ch, cw = max(ch, 1), max(cw, 1)
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        return CropTransform(x0, y0, cw, ch)
