"""Standalone COCO evaluation of a model (the JAX package's
``tools/eval_coco.py``):

    python -m yolov7_d2_tpu_torch.eval_coco \
        --config-file configs/coco/yolox_kpts_swin.yaml \
        --json ANNOTATIONS.json --image-root IMAGES [--weights W] \
        [--batch 8] [KEY VALUE ...]

The images of ``--json`` go through ``SimpleDatasetMapper(is_train=False)``
in batches of ``--batch``, as uint8 through the model (the normalize
kernel) on ``MODEL.DEVICE`` (``cuda`` by default; ``cpu`` on request; a
CUDA device without a card raises), then the tail: ``yolox_postprocess``
for YOLOX, ``yolox_kpts_postprocess`` for YOLOX_KPTS (the NMS kernel);
another architecture raises, as ``Predictor`` does. Boxes and keypoints are
divided by the letterbox scale; the ground truth is the mapper's boxes and
keypoints over the same scale, the keypoints' OKS areas those of the gt
boxes. Prints the box AP keys of ``COCOEvaluator`` and, for YOLOX_KPTS, the
``kpt_`` keys of ``COCOKeypointEvaluator``, and returns both.

``--weights`` is a state dict with the reference's names (``.pth`` /
``.pt`` / ``.pkl``, ``load_torch_checkpoint``) or the port's checkpoint
directory (``OUTPUT_DIR/ckpt``), of which the latest checkpoint's EMA
weights are taken; without it the weights are random from seed 0.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

ARCHS = ("YOLOX", "YOLOX_KPTS")


def build_argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default="")
    p.add_argument("--json", default="", help="COCO annotation json")
    p.add_argument("--image-root", default="")
    p.add_argument("--weights", default="")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p


def _print(results: Dict[str, float], prefix: str = "") -> None:
    for k, v in results.items():
        print(f"{prefix}{k}: {v:.4f}" if np.isfinite(v)
              else f"{prefix}{k}: nan")


def main(args) -> Dict[str, Optional[Dict[str, float]]]:
    """Evaluate; returns ``{"bbox": box metrics, "keypoints": keypoint
    metrics or None}``."""
    from yolov7_d2_tpu_torch.config import YoloxConfig, YoloxKptsConfig
    from yolov7_d2_tpu_torch.data.coco import load_coco_json
    from yolov7_d2_tpu_torch.data.loader import (
        build_detection_test_loader,
        exact_uint8,
    )
    from yolov7_d2_tpu_torch.data.mappers import SimpleDatasetMapper
    from yolov7_d2_tpu_torch.engine import resolve_device
    from yolov7_d2_tpu_torch.evaluation.coco_eval import (
        COCOEvaluator,
        COCOKeypointEvaluator,
    )
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess
    from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import (
        yolox_kpts_postprocess,
    )
    from yolov7_d2_tpu_torch.train.checkpoint import load_weights
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    cfg = setup_cfg(args)
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch not in ARCHS:
        raise NotImplementedError(
            f"eval_coco evaluates {ARCHS}, not {arch!r}: its outputs need "
            "their own tail")
    kpts_mode = arch == "YOLOX_KPTS"
    mcfg = (YoloxKptsConfig if kpts_mode else YoloxConfig).from_cfg(cfg)
    device = resolve_device(cfg.MODEL.DEVICE)
    model = build_model(mcfg, device, seed=0)
    if args.weights:
        n, report = load_weights(model, args.weights)
        print(f"ported {n - len(report.unexpected_keys)}, unmatched "
              f"{len(report.unexpected_keys)}, missing "
              f"{len(report.missing_keys)}")
    tail = yolox_kpts_postprocess if kpts_mode else yolox_postprocess

    records = load_coco_json(args.json, args.image_root)
    mapper = SimpleDatasetMapper(cfg, is_train=False)
    loader = build_detection_test_loader(cfg, records, mapper, args.batch)
    evaluator = COCOEvaluator(cfg.MODEL.YOLO.CLASSES)
    kpt_eval = COCOKeypointEvaluator(1) if kpts_mode else None
    for batch in loader:
        with torch.inference_mode():
            images = torch.from_numpy(exact_uint8(batch["image"]))
            dets = tail(model(images.to(device)),
                        conf_threshold=mcfg.conf_threshold,
                        nms_threshold=mcfg.nms_threshold,
                        max_detections=mcfg.max_detections,
                        pre_nms_topk=mcfg.pre_nms_topk)
        boxes, scores, classes, valid = (
            t.cpu().numpy() for t in (dets.boxes, dets.scores, dets.classes,
                                      dets.valid))
        for i in range(len(batch["image"])):
            img_id = int(batch["image_id"][i])
            scale = float(batch["scale"][i])
            v = valid[i]
            evaluator.add_predictions(img_id, boxes[i][v] / scale,
                                      scores[i][v], classes[i][v])
            gv = batch["gt_valid"][i]
            gb = batch["gt_boxes"][i][gv] / scale
            evaluator.add_gt(img_id, gb, batch["gt_classes"][i][gv])
            if kpt_eval is not None:
                kp = dets.keypoints[i].cpu().numpy()[v].copy()
                kp[..., :2] /= scale
                kpt_eval.add_pred_keypoints(img_id, kp, scores[i][v])
                gkp = np.asarray(batch["gt_keypoints"][i][gv], np.float64)
                gkp[..., :2] /= scale
                kpt_eval.add_gt_keypoints(
                    img_id, gkp,
                    areas=(gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]),
                    boxes=np.stack([gb[:, 0], gb[:, 1], gb[:, 2] - gb[:, 0],
                                    gb[:, 3] - gb[:, 1]], -1))
    results = {"bbox": evaluator.evaluate(), "keypoints": None}
    _print(results["bbox"])
    if kpt_eval is not None:
        results["keypoints"] = kpt_eval.evaluate()
        print("-- keypoints (OKS) --")
        _print(results["keypoints"], "kpt_")
    return results


if __name__ == "__main__":
    main(build_argument_parser().parse_args())
