"""COCO-style box, mask and keypoint mAP evaluation in numpy (copied from
``yolov7_d2_tpu/evaluation/coco_eval.py``: ``COCOEvaluator`` with its box
and mask IoU and matching helpers, ``COCOMaskEvaluator`` for the box-free
SparseInst, ``polygons_to_mask``, and ``oks_matrix`` with
``COCOKeypointEvaluator`` for YOLOX-KPTS).

  * IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1
  * area ranges all / small(<32^2) / medium / large(>96^2)
  * maxDets 100 for AP; greedy score-ordered matching, crowd handling
  * 101-point interpolated precision
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


IOU_THRS = np.linspace(0.5, 0.95, 10)


REC_THRS = np.linspace(0.0, 1.0, 101)


AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def box_iou_matrix(
    dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray
) -> np.ndarray:
    """IoU [D, G] for xyxy boxes; crowd GTs use intersection-over-det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    x0 = np.maximum(dets[:, None, 0], gts[None, :, 0])
    y0 = np.maximum(dets[:, None, 1], gts[None, :, 1])
    x1 = np.minimum(dets[:, None, 2], gts[None, :, 2])
    y1 = np.minimum(dets[:, None, 3], gts[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), area_d[:, None], union)
    return inter / np.maximum(union, 1e-10)


def mask_iou_matrix(
    det_masks: Sequence[np.ndarray],
    gt_masks: Sequence[np.ndarray],
    iscrowd: np.ndarray,
) -> np.ndarray:
    """IoU [D, G] of binary masks; crowd GTs use intersection over the
    detection's area."""
    if len(det_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(det_masks), len(gt_masks)))
    d = np.stack([m.astype(bool).ravel() for m in det_masks]).astype(np.float32)
    g = np.stack([m.astype(bool).ravel() for m in gt_masks]).astype(np.float32)
    inter = d @ g.T
    area_d = d.sum(1)
    area_g = g.sum(1)
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), area_d[:, None], union)
    return inter / np.maximum(union, 1e-10)


def _match_image(
    ious: np.ndarray,
    det_scores: np.ndarray,
    gt_ignore: np.ndarray,
    iscrowd: np.ndarray,
    iou_thr: float,
):
    """Greedy COCO matching for one image/category at one IoU threshold.

    Returns (det_matched_gt [-1 unmatched], det_ignore) with dets assumed
    pre-sorted by descending score.
    """
    n_det, n_gt = ious.shape
    gt_taken = np.zeros(n_gt, bool)
    det_match = np.full(n_det, -1)
    det_ignore = np.zeros(n_det, bool)
    for d in range(n_det):
        best, best_iou = -1, min(iou_thr, 1 - 1e-10)
        for g in range(n_gt):
            if gt_taken[g] and not iscrowd[g]:
                continue
            # prefer non-ignored matches: once matched to a real gt, only
            # switch to ignored gt if nothing real available
            if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                break
            if ious[d, g] < best_iou:
                continue
            best_iou = ious[d, g]
            best = g
        if best > -1:
            det_match[d] = best
            det_ignore[d] = gt_ignore[best]
            if not iscrowd[best]:
                gt_taken[best] = True
    return det_match, det_ignore


class COCOEvaluator:
    """Accumulates per-image predictions, computes COCO AP/AR.

    ``iou_type``: 'bbox' or 'segm'. For 'segm', predictions and GT carry
    binary masks at the original image's resolution."""

    def __init__(self, num_classes: int, iou_type: str = "bbox"):
        self.num_classes = num_classes
        self.iou_type = iou_type
        self.area_ranges = dict(AREA_RANGES)
        self.max_dets = 100
        self.reset()

    def reset(self) -> None:
        self._gts: Dict[int, List[dict]] = defaultdict(list)
        self._dets: Dict[int, List[dict]] = defaultdict(list)
        self._image_ids: set = set()

    def add_gt(
        self,
        image_id: int,
        boxes: np.ndarray,
        classes: np.ndarray,
        iscrowd: Optional[np.ndarray] = None,
        areas: Optional[np.ndarray] = None,
        masks: Optional[Sequence[np.ndarray]] = None,
    ) -> None:
        self._image_ids.add(image_id)
        iscrowd = (
            iscrowd if iscrowd is not None else np.zeros(len(boxes), bool)
        )
        if areas is None:
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        for i in range(len(boxes)):
            self._gts[image_id].append(
                {
                    "bbox": boxes[i],
                    "class": int(classes[i]),
                    "iscrowd": bool(iscrowd[i]),
                    "area": float(areas[i]),
                    "mask": masks[i] if masks is not None else None,
                }
            )

    def add_predictions(
        self,
        image_id: int,
        boxes: np.ndarray,
        scores: np.ndarray,
        classes: np.ndarray,
        masks: Optional[Sequence[np.ndarray]] = None,
    ) -> None:
        self._image_ids.add(image_id)
        for i in range(len(boxes)):
            self._dets[image_id].append(
                {
                    "bbox": boxes[i],
                    "score": float(scores[i]),
                    "class": int(classes[i]),
                    "mask": masks[i] if masks is not None else None,
                }
            )

    # -- core ---------------------------------------------------------------
    def _evaluate_img_cat(
        self, image_id: int, cat: int, area_rng, max_dets: int
    ):
        gts = [g for g in self._gts[image_id] if g["class"] == cat]
        dets = [d for d in self._dets[image_id] if d["class"] == cat]
        if not gts and not dets:
            return None
        dets = sorted(dets, key=lambda d: -d["score"])[:max_dets]
        gt_ignore = np.array(
            [
                g["iscrowd"]
                or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            bool,
        )
        # sort gts: non-ignored first (COCO convention)
        order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in order]
        gt_ignore = gt_ignore[order]
        iscrowd = np.array([g["iscrowd"] for g in gts], bool)

        if self.iou_type == "segm":
            ious = mask_iou_matrix(
                [d["mask"] for d in dets], [g["mask"] for g in gts], iscrowd
            )
        else:
            gt_boxes = (
                np.stack([g["bbox"] for g in gts])
                if gts
                else np.zeros((0, 4))
            )
            det_boxes = (
                np.stack([d["bbox"] for d in dets])
                if dets
                else np.zeros((0, 4))
            )
            ious = box_iou_matrix(det_boxes, gt_boxes, iscrowd)

        scores = np.array([d["score"] for d in dets])
        # pycocotools det 'area' (used for the unmatched-det area ignore):
        # bbox w*h for iouType 'bbox', MASK PIXEL AREA for 'segm'
        # (pycocotools coco.loadRes: ann['area'] = maskUtils.area(rle))
        if self.iou_type == "segm":
            det_areas = (
                np.array([float(np.count_nonzero(d["mask"])) for d in dets])
                if dets
                else np.zeros((0,))
            )
        else:
            det_areas = (
                (lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))(
                    np.stack([d["bbox"] for d in dets])
                )
                if dets
                else np.zeros((0,))
            )
        out = []
        for t in IOU_THRS:
            match, ignore = _match_image(ious, scores, gt_ignore, iscrowd, t)
            # unmatched dets outside the area range are ignored, not FPs
            ignore = ignore | (
                (match == -1)
                & ((det_areas < area_rng[0]) | (det_areas > area_rng[1]))
            )
            out.append((match, ignore))
        return {
            "scores": scores,
            "matches": out,
            "num_gt": int((~gt_ignore).sum()),
        }

    def _accumulate_cat(self, cat: int, area: str, max_dets: int):
        area_rng = self.area_ranges[area]
        per_img = [
            self._evaluate_img_cat(i, cat, area_rng, max_dets)
            for i in sorted(self._image_ids)
        ]
        per_img = [p for p in per_img if p is not None]
        if not per_img:
            return None
        total_gt = sum(p["num_gt"] for p in per_img)
        if total_gt == 0:
            return None
        scores = np.concatenate([p["scores"] for p in per_img])
        order = np.argsort(-scores, kind="mergesort")
        ap_per_thr = np.zeros(len(IOU_THRS))
        recall_per_thr = np.zeros(len(IOU_THRS))
        for ti in range(len(IOU_THRS)):
            tp = np.concatenate(
                [
                    (p["matches"][ti][0] >= 0) & ~p["matches"][ti][1]
                    for p in per_img
                ]
            )[order]
            ig = np.concatenate([p["matches"][ti][1] for p in per_img])[order]
            tp, fp = tp[~ig], (~tp[~ig])
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(fp)
            recall = tp_cum / total_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
            # make precision monotonically decreasing
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            # 101-point interpolation
            idx = np.searchsorted(recall, REC_THRS, side="left")
            prec_at = np.zeros(len(REC_THRS))
            valid = idx < len(precision)
            prec_at[valid] = precision[idx[valid]]
            ap_per_thr[ti] = prec_at.mean()
            recall_per_thr[ti] = recall[-1] if len(recall) else 0.0
        return ap_per_thr, recall_per_thr

    def evaluate(self) -> Dict[str, float]:
        per_cat = {
            area: [] for area in self.area_ranges
        }
        recalls = []
        for cat in range(self.num_classes):
            for area in self.area_ranges:
                res = self._accumulate_cat(cat, area, max_dets=self.max_dets)
                if res is not None:
                    per_cat[area].append(res[0])
                    if area == "all":
                        recalls.append(res[1])

        def mean_ap(area, thr_idx=None):
            if area not in per_cat or not per_cat[area]:
                return float("nan")
            arr = np.stack(per_cat[area])
            return float(
                arr.mean() if thr_idx is None else arr[:, thr_idx].mean()
            )

        return {
            "AP": mean_ap("all"),
            "AP50": mean_ap("all", 0),
            "AP75": mean_ap("all", 5),
            "APs": mean_ap("small"),
            "APm": mean_ap("medium"),
            "APl": mean_ap("large"),
            "AR100": (
                float(np.stack(recalls).mean()) if recalls else float("nan")
            ),
        }


COCO_KPT_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ]
)


def oks_matrix(
    det_kpts: np.ndarray,   # [D, P, 3] (x, y, score)
    gt_kpts: np.ndarray,    # [G, P, 3] (x, y, visibility)
    gt_areas: np.ndarray,   # [G]
    sigmas: Optional[np.ndarray] = None,
    gt_boxes: Optional[np.ndarray] = None,  # [G, 4] xywh, for the v==0 case
) -> np.ndarray:
    """Object-keypoint-similarity matrix [D, G] (the COCO OKS formula).

    GTs with no visible keypoint use the COCO fallback: the per-keypoint
    distance is measured to the GT box expanded by its own size on every
    side (so detections inside the vicinity of an unannotated person score
    high against it and get ignored rather than counted as FPs).
    """
    if len(det_kpts) == 0 or len(gt_kpts) == 0:
        return np.zeros((len(det_kpts), len(gt_kpts)))
    s = sigmas if sigmas is not None else COCO_KPT_SIGMAS[: det_kpts.shape[1]]
    var = (2 * s) ** 2
    vis = gt_kpts[:, :, 2] > 0                          # [G, P]
    dx = det_kpts[:, None, :, 0] - gt_kpts[None, :, :, 0]
    dy = det_kpts[:, None, :, 1] - gt_kpts[None, :, :, 1]
    if gt_boxes is not None:
        x0 = gt_boxes[:, 0] - gt_boxes[:, 2]
        x1 = gt_boxes[:, 0] + 2 * gt_boxes[:, 2]
        y0 = gt_boxes[:, 1] - gt_boxes[:, 3]
        y1 = gt_boxes[:, 1] + 2 * gt_boxes[:, 3]
        fdx = (
            np.maximum(0.0, x0[None, :, None] - det_kpts[:, None, :, 0])
            + np.maximum(0.0, det_kpts[:, None, :, 0] - x1[None, :, None])
        )
        fdy = (
            np.maximum(0.0, y0[None, :, None] - det_kpts[:, None, :, 1])
            + np.maximum(0.0, det_kpts[:, None, :, 1] - y1[None, :, None])
        )
        none_vis = ~vis.any(-1)                         # [G]
        dx = np.where(none_vis[None, :, None], fdx, dx)
        dy = np.where(none_vis[None, :, None], fdy, dy)
    e = (
        (dx**2 + dy**2)
        / var[None, None, :]
        / (gt_areas[None, :, None] + np.spacing(1))
        / 2
    )
    any_vis = vis.any(-1)                               # [G]
    use = np.where(any_vis[:, None], vis, True)         # [G, P]
    oks = np.where(use[None], np.exp(-e), 0.0).sum(-1)
    n = np.maximum(use.sum(-1), 1)                      # [G]
    return oks / n[None, :]


class COCOKeypointEvaluator(COCOEvaluator):
    """Keypoint AP (JAX ``evaluation/coco_eval.py:379``): greedy matching
    on OKS instead of box IoU (pycocotools' 'keypoints' iouType), the COCO
    keypoint parameters (areas all / medium / large, maxDets 20); a
    detection's area and box come from its keypoints' extent."""

    def __init__(self, num_classes: int = 1):
        super().__init__(num_classes, iou_type="keypoints")
        self.area_ranges = {
            k: AREA_RANGES[k] for k in ("all", "medium", "large")
        }
        self.max_dets = 20

    def _evaluate_img_cat(self, image_id, cat, area_rng, max_dets):
        gts = [g for g in self._gts[image_id] if g["class"] == cat]
        dets = [d for d in self._dets[image_id] if d["class"] == cat]
        if not gts and not dets:
            return None
        dets = sorted(dets, key=lambda d: -d["score"])[:max_dets]
        gt_ignore = np.array(
            [
                g["iscrowd"] or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            bool,
        )
        order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in order]
        gt_ignore = gt_ignore[order]
        iscrowd = np.array([g["iscrowd"] for g in gts], bool)
        ious = oks_matrix(
            np.stack([d["mask"] for d in dets]) if dets else np.zeros((0, 17, 3)),
            np.stack([g["mask"] for g in gts]) if gts else np.zeros((0, 17, 3)),
            np.array([g["area"] for g in gts]) if gts else np.zeros((0,)),
            gt_boxes=(
                np.stack([g["bbox"] for g in gts]) if gts
                else np.zeros((0, 4))
            ),
        )
        scores = np.array([d["score"] for d in dets])
        # det area = keypoint-extent box area (pycocotools loadRes for
        # 'keypoints' results), used for the unmatched-det area ignore
        det_areas = np.array([d["area"] for d in dets])
        out = []
        for t in IOU_THRS:
            match, ignore = _match_image(ious, scores, gt_ignore, iscrowd, t)
            ignore = ignore | (
                (match == -1)
                & ((det_areas < area_rng[0]) | (det_areas > area_rng[1]))
            )
            out.append((match, ignore))
        return {
            "scores": scores,
            "matches": out,
            "num_gt": int((~gt_ignore).sum()),
        }

    def add_gt_keypoints(self, image_id, keypoints, areas, classes=None,
                         boxes=None, iscrowd=None):
        """keypoints [G, P, 3]; areas [G] (the OKS scale); boxes [G, 4]
        xywh (the vicinity box for all-invisible GTs)."""
        self._image_ids.add(image_id)
        for i in range(len(keypoints)):
            kp = np.asarray(keypoints[i])
            if boxes is not None:
                bb = np.asarray(boxes[i], np.float64)
            else:
                vis = kp[:, 2] > 0
                pts = kp[vis] if vis.any() else kp
                bb = np.array([
                    pts[:, 0].min(), pts[:, 1].min(),
                    pts[:, 0].max() - pts[:, 0].min(),
                    pts[:, 1].max() - pts[:, 1].min(),
                ])
            self._gts[image_id].append(
                {
                    "bbox": bb,
                    "class": int(classes[i]) if classes is not None else 0,
                    "iscrowd": (
                        bool(iscrowd[i]) if iscrowd is not None else False
                    ),
                    "area": float(areas[i]),
                    "mask": kp,  # kpts ride this slot
                }
            )

    def add_pred_keypoints(self, image_id, keypoints, scores, classes=None):
        self._image_ids.add(image_id)
        for i in range(len(keypoints)):
            kp = np.asarray(keypoints[i])
            x0, x1 = kp[:, 0].min(), kp[:, 0].max()
            y0, y1 = kp[:, 1].min(), kp[:, 1].max()
            self._dets[image_id].append(
                {
                    "bbox": np.array([x0, y0, x1 - x0, y1 - y0]),
                    "area": float((x1 - x0) * (y1 - y0)),
                    "score": float(scores[i]),
                    "class": int(classes[i]) if classes is not None else 0,
                    "mask": kp,
                }
            )


class COCOMaskEvaluator(COCOEvaluator):
    """Instance-segmentation evaluator (box-free, the reference's
    ``coco_evaluation.py:79``: SparseInst outputs have no boxes; IoUs come
    from masks, boxes only bin the areas)."""

    def __init__(self, num_classes: int):
        super().__init__(num_classes, iou_type="segm")


def polygons_to_mask(polygons, height: int, width: int) -> np.ndarray:
    """Rasterize a COCO polygon segmentation to a binary mask."""
    import cv2

    mask = np.zeros((height, width), np.uint8)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask.astype(bool)
