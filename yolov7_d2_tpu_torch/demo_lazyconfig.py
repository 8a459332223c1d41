"""Inference from a LazyConfig python file (JAX ``demo_lazyconfig.py``).

    python -m yolov7_d2_tpu_torch.demo_lazyconfig --config-file \\
        configs/common/yolox_s_lazy.py -i IMG [IMG ...] [--output DIR] \\
        [--input-size 640] [-c 0.25] [--device cpu]

Instantiates ``cfg["model"]`` with weights from seed 0, on the card unless
``--device`` says otherwise, letterboxes each image to the input size, and
runs the model and YOLOX's serving tail (normalize and NMS kernels on the
card), as the JAX demo does (YOLOX only: its tail is YOLOX's); draws the
detections into ``--output``.
"""

from __future__ import annotations

import argparse
import glob
import os

import cv2
import numpy as np
import torch

from yolov7_d2_tpu_torch.config.lazy import LazyConfig, instantiate
from yolov7_d2_tpu_torch.data.transforms.augment import letterbox
from yolov7_d2_tpu_torch.demo import vis_res_fast
from yolov7_d2_tpu_torch.engine import resolve_device
from yolov7_d2_tpu_torch.models.build import init_weights_
from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", required=True, help="LazyConfig .py")
    p.add_argument("-i", "--input", nargs="+", required=True)
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("-c", "--confidence-threshold", type=float, default=0.25)
    p.add_argument("--output", default="demo_out")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = LazyConfig.load(args.config_file)
    model = instantiate(cfg["model"])
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    size = (args.input_size, args.input_size)
    os.makedirs(args.output, exist_ok=True)
    paths = []
    for pattern in args.input:
        paths.extend(glob.glob(pattern) if "*" in pattern else [pattern])
    results = []
    for path in paths:
        img = cv2.imread(path)
        if img is None:
            continue
        x, _, scale = letterbox(img, np.zeros((0, 4), np.float32), size)
        with torch.inference_mode():
            out = model(torch.from_numpy(
                np.ascontiguousarray(x[None])).to(device))
            dets = yolox_postprocess(
                out, conf_threshold=args.confidence_threshold)
        valid = dets.valid[0].cpu().numpy()
        vis = vis_res_fast(img, dets.boxes[0].cpu().numpy()[valid] / scale,
                           dets.scores[0].cpu().numpy()[valid],
                           dets.classes[0].cpu().numpy()[valid])
        out_path = os.path.join(args.output, os.path.basename(path))
        cv2.imwrite(out_path, vis)
        print(f"{path}: {int(valid.sum())} dets -> {out_path}")
        results.append((path, dets))
    return results


if __name__ == "__main__":
    main()
