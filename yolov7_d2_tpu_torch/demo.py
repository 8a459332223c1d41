"""Single-image / directory / video inference and visualization of the
port (the JAX package's ``demo.py``):

    python -m yolov7_d2_tpu_torch.demo \
        --config-file configs/coco/yolox_s.yaml \
        -i IMAGE [IMAGE|DIR/*.jpg|VIDEO|webcam ...] --output DIR \
        [-c CONF] [--nms-threshold T] [--weights W] [KEY VALUE ...]

``--weights`` (else ``MODEL.WEIGHTS``) is a reference-format ``.pth`` /
``.pt`` / ``.pkl`` state dict, whose names are the port's, or the port's
own checkpoint directory (``OUTPUT_DIR/ckpt`` of ``train_det``), of which
the latest checkpoint's EMA weights are taken. Each image is letterboxed
(``data/transforms/augment.letterbox``) and goes through
``Predictor.predict_batch`` (the normalize and NMS kernels); boxes are
drawn with OpenCV. It runs on ``MODEL.DEVICE`` (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import cv2
import numpy as np

from yolov7_d2_tpu_torch.config import YoloxConfig
from yolov7_d2_tpu_torch.engine import resolve_device
from yolov7_d2_tpu_torch.models.build import build_model
from yolov7_d2_tpu_torch.predictor import Predictor
from yolov7_d2_tpu_torch.train.checkpoint import load_weights


def build_predictor(cfg, weights_path: str = "") -> Predictor:
    """A ``Predictor`` of the config's model on ``MODEL.DEVICE``, with the
    weights of ``weights_path`` (else ``MODEL.WEIGHTS``; random weights
    from seed 0 where neither is given)."""
    ycfg = YoloxConfig.from_cfg(cfg)
    device = resolve_device(cfg.MODEL.DEVICE)
    model = build_model(ycfg, device, seed=0)
    weights_path = weights_path or cfg.MODEL.WEIGHTS
    if weights_path:
        _, report = load_weights(model, weights_path)
        if report.missing_keys or report.unexpected_keys:
            print(f"warning: {len(report.missing_keys)} weights missing, "
                  f"{len(report.unexpected_keys)} unmatched keys")
    return Predictor(ycfg, device, model=model)


def vis_res_fast(img, boxes, scores, classes, class_names=None):
    """Draw boxes (the counterpart of reference demo.py:139)."""
    rng = np.random.default_rng(3)
    colors = rng.integers(60, 255, (80, 3))
    for box, score, cls in zip(boxes, scores, classes):
        x0, y0, x1, y1 = [int(v) for v in box]
        color = tuple(int(c) for c in colors[int(cls) % 80])
        cv2.rectangle(img, (x0, y0), (x1, y1), color, 2)
        label = (
            class_names[int(cls)] if class_names else str(int(cls))
        ) + f" {score:.2f}"
        cv2.putText(
            img, label, (x0, max(y0 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
            0.5, color, 1,
        )
    return img


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", default="")
    parser.add_argument("-i", "--input", nargs="+", required=True)
    parser.add_argument("--output", default="demo_out")
    parser.add_argument("-c", "--confidence-threshold", type=float, default=0.25)
    parser.add_argument("--nms-threshold", type=float, default=0.65)
    parser.add_argument("--weights", default="")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.MODEL.YOLO.CONF_THRESHOLD = args.confidence_threshold
    cfg.MODEL.YOLO.NMS_THRESHOLD = args.nms_threshold
    cfg.freeze()

    predictor = build_predictor(cfg, args.weights)
    os.makedirs(args.output, exist_ok=True)

    def run_video(source):
        """Video file / webcam loop (reference demo.py video path)."""
        cap = cv2.VideoCapture(0 if source == "webcam" else source)
        writer = None
        n = 0
        while cap.isOpened():
            ok, frame = cap.read()
            if not ok:
                break
            res = predictor(frame)
            vis = vis_res_fast(
                frame, res["boxes"], res["scores"], res["classes"]
            )
            if writer is None and source != "webcam":
                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                fps = cap.get(cv2.CAP_PROP_FPS) or 25
                writer = cv2.VideoWriter(
                    os.path.join(args.output, "out_" + os.path.basename(source)),
                    fourcc, fps, (vis.shape[1], vis.shape[0]),
                )
            if writer is not None:
                writer.write(vis)
            n += 1
        cap.release()
        if writer is not None:
            writer.release()
        print(f"{source}: processed {n} frames")

    paths = []
    for pattern in args.input:
        if os.path.isdir(pattern):
            paths.extend(sorted(glob.glob(os.path.join(pattern, "*"))))
        else:
            paths.extend(glob.glob(pattern) if "*" in pattern else [pattern])
    for path in paths:
        if path == "webcam" or path.endswith((".mp4", ".avi", ".mov", ".mkv")):
            run_video(path)
            continue
        img = cv2.imread(path)
        if img is None:
            print(f"skip unreadable {path}")
            continue
        t0 = time.time()
        res = predictor(img)
        dt = time.time() - t0
        print(f"{path}: {len(res['boxes'])} dets in {dt*1000:.1f} ms")
        vis = vis_res_fast(img, res["boxes"], res["scores"], res["classes"])
        cv2.imwrite(
            os.path.join(args.output, os.path.basename(path)), vis
        )


if __name__ == "__main__":
    main()
