"""Export a model as a serving artifact (JAX ``export.py``):

    python -m yolov7_d2_tpu_torch.export --config-file CONFIG.yaml \\
        [--output DIR] [--batch N] [--fuse-postprocess] [--emit-package] \\
        [--weights W] [KEY VALUE ...]

writes ``DIR/model.pt2`` (a ``torch.export`` program with the weights in
it, ``deploy/export.load_program`` loads it) and ``DIR/export_meta.json``.
The input is a float32 NHWC batch of ``N`` images at
``INPUT.INPUT_SIZE``. ``--fuse-postprocess`` puts YOLOX's tail (decode
and the NMS kernel) into the program, whose outputs are then ``(boxes,
scores, classes, valid)``; without it the program returns the model's
outputs, for any architecture the port builds. ``--weights`` loads a
reference-format checkpoint straight into the model (the port keeps the
reference's names) and prints the ported and unmatched counts. Weights are
otherwise drawn from seed 0. The model is built on ``MODEL.DEVICE`` (the
card unless ``MODEL.DEVICE cpu``). ``--emit-package`` (the JAX CLI's
``--emit-mlir``) also compiles the program with AOTInductor on that device
into ``DIR/model_aoti.pt2``, which the native client
``deploy/cc/aoti_infer.cpp`` serves without Python.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config-file", default="")
    parser.add_argument("--output", default="export_out")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--fuse-postprocess", action="store_true",
                        help="put YOLOX's decode and NMS into the program")
    parser.add_argument("--emit-package", action="store_true",
                        help="also write the AOTInductor package "
                             "model_aoti.pt2 for the native client")
    parser.add_argument("--weights", default="")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def yolox_tail(cfg):
    """The fused postprocess of the JAX CLI: ``yolox_postprocess`` at the
    config's thresholds, as a tuple ``(boxes, scores, classes, valid)``."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess

    def post(out):
        d = yolox_postprocess(out, cfg.conf_threshold, cfg.nms_threshold,
                              cfg.max_detections, cfg.pre_nms_topk)
        return d.boxes, d.scores, d.classes, d.valid

    return post


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    from yolov7_d2_tpu_torch.config.defaults import get_cfg
    from yolov7_d2_tpu_torch.deploy.export import export_inference_fn
    from yolov7_d2_tpu_torch.engine import config_from_cfg, resolve_device
    from yolov7_d2_tpu_torch.models.build import build_model

    node = get_cfg()
    if args.config_file:
        node.merge_from_file(args.config_file)
    if args.opts:
        node.merge_from_list(args.opts)
    node.freeze()
    cfg = config_from_cfg(node)
    if args.fuse_postprocess and cfg.meta_architecture != "YOLOX":
        raise NotImplementedError(
            "--fuse-postprocess fuses YOLOX's tail (as the JAX CLI does); "
            f"export {cfg.meta_architecture} without it")
    device = resolve_device(node.MODEL.DEVICE)
    model = build_model(cfg, device)
    if args.weights:
        from yolov7_d2_tpu_torch.utils.weight_port import (
            load_torch_checkpoint,
        )

        own = model.state_dict()
        sd = load_torch_checkpoint(args.weights)
        ported = {k: v for k, v in sd.items()
                  if k in own and tuple(v.shape) == tuple(own[k].shape)}
        model.load_state_dict(ported, strict=False)
        print(f"ported {len(ported)} tensors, {len(sd) - len(ported)} "
              "unmatched")
    h, w = cfg.input_size
    paths = export_inference_fn(
        model, (args.batch, h, w, 3), args.output,
        postprocess=yolox_tail(cfg) if args.fuse_postprocess else None,
        package=args.emit_package)
    print(f"exported: {paths}")
    return paths


if __name__ == "__main__":
    main()
