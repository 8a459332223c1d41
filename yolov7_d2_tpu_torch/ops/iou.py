"""Box IoU, generalized IoU and the IoU loss family (JAX ``ops/iou.py:19-157``).

The operations and their order are those of the JAX functions, one rounding
each, so that the plain NMS and the NMS kernel take the same decisions at
the threshold, and SimOTA and the losses see the JAX package's values.
"""

from __future__ import annotations

import math

import torch

from yolov7_d2_tpu_torch.structures.boxes import cxcywh_to_xyxy

EPS = 1e-9


def elementwise_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of aligned xyxy boxes ``a[..., 4]`` and ``b[..., 4]``."""
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    bx0, by0, bx1, by1 = b.unbind(-1)
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp(min=0.0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp(min=0.0)
    inter = iw * ih
    area_a = (ax1 - ax0).clamp(min=0.0) * (ay1 - ay0).clamp(min=0.0)
    area_b = (bx1 - bx0).clamp(min=0.0) * (by1 - by0).clamp(min=0.0)
    return inter / (area_a + area_b - inter + EPS)


def pairwise_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, 4] x b [..., M, 4] -> [..., N, M]."""
    return elementwise_box_iou(a[..., :, None, :], b[..., None, :, :])


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned xyxy boxes: the IoU less the enclosing box's share
    outside the union, as the JAX ``pairwise_generalized_box_iou``
    computes each pair (the union from unclamped areas)."""
    iou = elementwise_box_iou(a, b)
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    bx0, by0, bx1, by1 = b.unbind(-1)
    enclose = ((torch.maximum(ax1, bx1) - torch.minimum(ax0, bx0))
               .clamp(min=0.0)
               * (torch.maximum(ay1, by1) - torch.minimum(ay0, by0))
               .clamp(min=0.0))
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp(min=0.0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp(min=0.0)
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - iw * ih
    return iou - (enclose - union) / (enclose + EPS)


def pairwise_generalized_box_iou(a: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """a [..., N, 4] x b [..., M, 4] -> GIoU [..., N, M] (DETR's matching
    cost, JAX :43)."""
    return generalized_box_iou(a[..., :, None, :], b[..., None, :, :])


def bbox_overlaps_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of center-format (cx, cy, w, h) boxes (JAX :69, the
    reference's ``bboxes_iou(xyxy=False)``)."""
    return pairwise_box_iou(cxcywh_to_xyxy(a), cxcywh_to_xyxy(b))


def _iou_terms(pred: torch.Tensor, target: torch.Tensor):
    """Shared terms of the IoU losses of aligned xyxy boxes, as the JAX
    ``_iou_terms`` computes them: unlike :func:`elementwise_box_iou`, the
    areas are not clamped. Returns the IoU, the widths and heights, the
    enclosing box's width and height and the coordinates."""
    px0, py0, px1, py1 = pred.unbind(-1)
    tx0, ty0, tx1, ty1 = target.unbind(-1)
    iw = (torch.minimum(px1, tx1) - torch.maximum(px0, tx0)).clamp(min=0.0)
    ih = (torch.minimum(py1, ty1) - torch.maximum(py0, ty0)).clamp(min=0.0)
    inter = iw * ih
    pw, ph = px1 - px0, py1 - py0
    tw, th = tx1 - tx0, ty1 - ty0
    union = pw * ph + tw * th - inter + EPS
    iou = inter / union
    cw = torch.maximum(px1, tx1) - torch.minimum(px0, tx0)
    ch = torch.maximum(py1, ty1) - torch.minimum(py0, ty0)
    return (iou, (pw, ph, tw, th), (cw, ch),
            (px0, py0, px1, py1, tx0, ty0, tx1, ty1))


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "iou") -> torch.Tensor:
    """Per-box loss of aligned xyxy boxes (JAX ``iou_loss``): ``iou`` is
    1 - iou^2 (the YOLOX IOUloss squares the IoU), ``linear_iou`` 1 - iou,
    ``giou`` / ``diou`` / ``ciou`` / ``siou`` 1 - {g,d,c,s}iou."""
    iou, (pw, ph, tw, th), (cw, ch), coords = _iou_terms(pred, target)
    px0, py0, px1, py1, tx0, ty0, tx1, ty1 = coords

    if loss_type == "iou":
        return 1.0 - iou * iou
    if loss_type == "linear_iou":
        return 1.0 - iou
    if loss_type == "giou":
        inter = iou * (pw * ph + tw * th) / (1.0 + iou)  # recover union*iou
        union = pw * ph + tw * th - inter + EPS
        enclose = cw * ch + EPS
        giou = iou - (enclose - union) / enclose
        return 1.0 - giou.clamp(-1.0, 1.0)

    # centre distances for diou / ciou
    pcx, pcy = (px0 + px1) * 0.5, (py0 + py1) * 0.5
    tcx, tcy = (tx0 + tx1) * 0.5, (ty0 + ty1) * 0.5
    rho2 = (pcx - tcx) ** 2 + (pcy - tcy) ** 2
    c2 = cw ** 2 + ch ** 2 + EPS

    if loss_type == "diou":
        return 1.0 - (iou - rho2 / c2)
    if loss_type == "ciou":
        v = (4.0 / math.pi ** 2) * (
            torch.atan(tw / (th + EPS)) - torch.atan(pw / (ph + EPS))) ** 2
        # alpha is a weight without gradient in the CIoU formulation
        alpha = (v / (1.0 - iou + v + EPS)).detach()
        return 1.0 - (iou - rho2 / c2 - alpha * v)
    if loss_type == "siou":
        # SCYLLA-IoU (the YOLOv6 reference's IOUlossV6 'siou')
        s_cw = (tcx - pcx) + EPS
        s_ch = (tcy - pcy) + EPS
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + EPS
        # float32 can put |s_ch| / sigma an ulp past 1, where arcsin is NaN
        sin_alpha = (s_ch.abs() / sigma).clamp(0.0, 1.0)
        sin_beta = (s_cw.abs() / sigma).clamp(0.0, 1.0)
        sin_alpha = torch.where(sin_alpha > math.sqrt(0.5), sin_beta,
                                sin_alpha)
        angle_cost = torch.cos(2.0 * (torch.asin(sin_alpha) - math.pi / 4.0))
        rho_x = (s_cw / (cw + EPS)) ** 2
        rho_y = (s_ch / (ch + EPS)) ** 2
        gamma = 2.0 - angle_cost
        dist_cost = ((1.0 - torch.exp(-gamma * rho_x))
                     + (1.0 - torch.exp(-gamma * rho_y)))
        omega_w = (pw - tw).abs() / (torch.maximum(pw, tw) + EPS)
        omega_h = (ph - th).abs() / (torch.maximum(ph, th) + EPS)
        shape_cost = ((1.0 - torch.exp(-omega_w)) ** 4
                      + (1.0 - torch.exp(-omega_h)) ** 4)
        return 1.0 - iou + 0.5 * (dist_cost + shape_cost)
    raise ValueError(f"Unknown iou loss type: {loss_type}")
