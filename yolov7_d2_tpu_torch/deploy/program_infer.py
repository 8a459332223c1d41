"""Serve one image from an exported program (JAX
``deploy/stablehlo_infer.py``):

    python -m yolov7_d2_tpu_torch.deploy.program_infer --model DIR/model.pt2 \\
        -i IMAGE [--input-size 640] [--conf 0.25] [--nms 0.65] \\
        [--device cuda|cpu]

loads ``model.pt2`` (``python -m yolov7_d2_tpu_torch.export
--fuse-postprocess``) with ``load_program``, letterboxes the image with the
port's ``letterbox`` and runs the program on ``--device`` (the card unless
``cpu``; the program's weights must be there, where it was exported). It
prints the milliseconds of the call and the detections at or above
``--conf``, their boxes scaled back to the image by the letterbox's scale.
A program exported without the tail exits asking for
``--fuse-postprocess``, as the JAX script does.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def numpy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float):
    """Plain numpy NMS (JAX ``deploy/stablehlo_infer.py:19``, the
    reference's ``ort_infer.py:19``): the kept indices, best first."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, help="model.pt2 path")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--nms", type=float, default=0.65)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    import cv2
    import torch

    from yolov7_d2_tpu_torch.data.transforms.augment import letterbox
    from yolov7_d2_tpu_torch.deploy.export import load_program
    from yolov7_d2_tpu_torch.engine import resolve_device

    device = resolve_device(args.device)
    program = load_program(args.model).module()
    img = cv2.imread(args.input)
    if img is None:
        raise SystemExit(f"cannot read {args.input}")
    x, _, scale = letterbox(img, np.zeros((0, 4), np.float32),
                            (args.input_size, args.input_size))
    x = torch.from_numpy(x[None].astype(np.float32)).to(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = program(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if not (isinstance(out, tuple) and len(out) == 4):
        raise SystemExit("raw-graph export: re-export with "
                         "--fuse-postprocess for the serving demo")
    boxes, scores, classes, valid = (o.cpu().numpy() for o in out)
    boxes, scores, classes = (boxes[0][valid[0]] / scale,
                              scores[0][valid[0]], classes[0][valid[0]])
    print(f"inference {dt * 1000:.1f} ms, {len(boxes)} detections")
    for b, s, c in zip(boxes, scores, classes):
        if s >= args.conf:
            print(f"  class {int(c)}  score {s:.3f}  box "
                  f"{b.round(1).tolist()}")
    return {"ms": dt * 1000, "boxes": boxes, "scores": scores,
            "classes": classes}


if __name__ == "__main__":
    main()
