"""Weight-only int8 demo (JAX ``deploy/demo_quantized_int8.py``):

    python -m yolov7_d2_tpu_torch.deploy.demo_quantized_int8 \\
        [--config-file CONFIG.yaml] [--batch 8] [KEY VALUE ...]

builds the config's model with the seed's weights on ``MODEL.DEVICE`` (the
card unless ``MODEL.DEVICE cpu``), quantizes its weights to int8
(``deploy/quantize.quantize_weights_int8``, one scale an output channel)
and prints the float32 and int8 parameter bytes (the scales left out, as
the JAX demo counts them), then the largest drift of the model's
``outputs`` on a seeded batch with the dequantized weights
(``dequantize_weights`` to float32) against the float32 weights.
"""

from __future__ import annotations

import argparse
import copy
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", default="")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    import numpy as np
    import torch

    from yolov7_d2_tpu_torch.config.defaults import get_cfg
    from yolov7_d2_tpu_torch.deploy.quantize import (
        dequantize_weights,
        quantize_weights_int8,
    )
    from yolov7_d2_tpu_torch.engine import config_from_cfg, resolve_device
    from yolov7_d2_tpu_torch.models.build import build_model

    node = get_cfg()
    if args.config_file:
        node.merge_from_file(args.config_file)
    if args.opts:
        node.merge_from_list(args.opts)
    node.freeze()
    device = resolve_device(node.MODEL.DEVICE)
    model = build_model(config_from_cfg(node), device).eval()
    h, w = node.INPUT.INPUT_SIZE
    images = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (args.batch, h, w, 3)).astype(np.float32)).to(device)

    qparams, scales = quantize_weights_int8(model)
    int8_bytes = sum(q.numel() for q in qparams.values()
                     if q.dtype == torch.int8)
    f32_bytes = sum(p.numel() * 4 for p in model.parameters())
    print(f"param bytes: f32 {f32_bytes / 1e6:.1f} MB -> int8+scales "
          f"~{int8_bytes / 1e6:.1f} MB")

    quantized = copy.deepcopy(model)
    quantized.load_state_dict(
        dequantize_weights(qparams, scales, dtype=torch.float32),
        strict=False)
    with torch.no_grad():
        ref = model(images)["outputs"].float()
        out = quantized(images)["outputs"].float()
    drift = float((ref - out).abs().max())
    rel = drift / (float(ref.abs().max()) + 1e-9)
    print(f"max output drift int8-weights vs f32: {drift:.4f} "
          f"(relative {rel:.4%})")
    return {"f32_bytes": f32_bytes, "int8_bytes": int8_bytes,
            "drift": drift, "relative": rel}


if __name__ == "__main__":
    main()
