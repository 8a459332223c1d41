#!/usr/bin/env python3
"""Where the time of the PyTorch port's YOLOX-s serving path, or of its
training step, goes on one CUDA card; with ``--yolov7``, YOLOV7's; with
``--sparseinst``, SparseInst R-50's; with ``--detr`` / ``--anchordetr``,
DETR R-50's / AnchorDETR R-50's; with ``--yolox-kpts``, YOLOX-KPTS on
Swin-T's.

    python3 tools/profile_torch_port.py            # serving
    python3 tools/profile_torch_port.py --train    # training step
    python3 tools/profile_torch_port.py --yolov7 [--train]
    python3 tools/profile_torch_port.py --sparseinst [--train]
    python3 tools/profile_torch_port.py --detr | --anchordetr [--train]
    python3 tools/profile_torch_port.py --yolox-kpts [--train]

Full-width YOLOX-s (or YOLOV7 from ``configs/coco/yolov7.yaml``'s
defaults) at 640, bf16, random weights from seed 0, uint8 batches already
on the card. Serving: for each batch size it prints e2e, forward-only and
tail milliseconds by CUDA events (YOLOX: ``Predictor``; YOLOV7:
``build_model`` and ``anchor_yolo_postprocess``), then traces three e2e
calls of the largest batch. Training: the step of ``build_yolox_system``
(YOLOV7: ``build_system``, EMA on) + ``make_packed_photo_step`` at 16
images with GridMask on, three steps traced after three of warm-up.
For the traced window it prints the device's busy share, the device time
by operator group (convolution, batch norm, SiLU, concat, ...) and the top
kernels by name. SparseInst (``configs/coco/sparseinst/
sparse_inst_r50_base.yaml``): serving through ``build_model`` and
``sparseinst_postprocess``; training through ``build_system`` (AdamW) on
16 images with 100 dense mask slots each (1-20 valid), and the auction
matcher alone on the step's outputs (ms and rounds). DETR and AnchorDETR
(``configs/coco/detr/detr_256_6_6_r50.yaml``, ``anchordetr_r50.yaml``) at
800: serving through ``build_model`` and the family's tail; training
through ``build_system`` (AdamW, the set criterion over 6 levels) on 8
images with 100 box slots each (1-20 valid), and the stacked six-level
auction alone on the step's outputs. YOLOX-KPTS
(``configs/coco/yolox_kpts_swin.yaml``, Swin-T) at 640: serving through
``build_model`` and ``yolox_kpts_postprocess``, then the window attention
alone at bs 128 (each stage's ``WindowAttention`` on its windows, shifted
with the mask, as the port runs it, and the same through
``F.scaled_dot_product_attention`` with the bias and mask as an additive
``attn_mask``, for comparison); training through ``build_system`` on 16
images (1-8 persons of 17 keypoints each), and SimOTA alone on the step's
outputs. Every line carries the card's name and power limit. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from yolov7_d2_tpu_torch.config import (  # noqa: E402
    AnchorYoloConfig,
    SparseInstConfig,
    YoloxConfig,
)
from yolov7_d2_tpu_torch.data.device_aug import (  # noqa: E402
    make_packed_photo_step,
)
from yolov7_d2_tpu_torch.engine import (  # noqa: E402
    build_system,
    build_yolox_system,
)
from yolov7_d2_tpu_torch.models.build import build_model  # noqa: E402
from yolov7_d2_tpu_torch.models.meta_arch import (  # noqa: E402
    sparseinst as si,
)
from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import (  # noqa: E402
    anchor_yolo_postprocess,
)
from yolov7_d2_tpu_torch.predictor import Predictor  # noqa: E402
from yolov7_d2_tpu_torch.utils.profiling import LAUNCH_CALLS  # noqa: E402

BATCHES = (1, 8, 32, 128)
TRAIN_BATCH = 16
TRACED_CALLS = 3
# kernel name -> group; the first pattern that matches wins
GROUPS = (
    ("normalize kernel (K2)", r"normalize_kernel"),
    ("NMS kernel (K1)", r"nms_kernel"),
    ("GridMask kernel (K3)", r"grid_mask_kernel"),
    ("optimizer and EMA (foreach)", r"multi_tensor_apply|foreach"),
    ("batch norm", r"batch_norm|bn_fw"),
    ("SiLU", r"silu"),
    ("mish", r"mish"),
    ("concat", r"CatArray|cat_"),
    ("max-pool", r"max_pool"),
    ("avg-pool", r"avg_pool"),
    ("upsample", r"upsample"),
    ("attention (SDPA)", r"flash|fmha|attention|efficient_attention"),
    ("softmax", r"softmax"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("GELU", r"gelu|GeluCUDA"),
    ("roll", r"roll"),
    ("sort / top-k", r"[Ss]ort|[Tt]op[Kk]|radix|bitonic"),
    # cuDNN runs the 1x1 convolutions as cuBLAS GEMMs (nvjet kernels), so
    # the linear layers' and einsums' GEMMs count here too
    ("convolution and GEMM", r"conv|xmma|implicit_gemm|fprop|cudnn|sm90_|cutlass|"
                    r"nvjet"),
    ("residual add", r"CUDAFunctor_add"),
    ("casts and copies", r"copy|cast"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def group_of(kernel: str) -> str:
    for name, pattern in GROUPS:
        if re.search(pattern, kernel):
            return name
    return "other elementwise and reductions"


def trace(fn, card: str, label: str) -> None:
    """Time ``fn`` untraced, then trace TRACED_CALLS calls and print the
    report. The profiler slows the host, so the busy share is given of
    both the traced window and the untraced call. The kernels the device
    trace holds are counted against the host's launch calls: on the H100
    machine used so far the trace of a training step held about 1240 of
    its 1955 launches (no SiLU or cast kernel), so its busy time is then a
    lower bound."""
    untraced = cuda_ms(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(TRACED_CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / TRACED_CALLS
    events = prof.key_averages()
    # device events, less the optimizer's record_function annotations
    # ("Optimizer.step#SGD.step"), which span kernels counted already
    kernels = [k for k in events
               if k.device_type == torch.autograd.DeviceType.CUDA
               and "#" not in k.key]
    launched = sum(k.count for k in events if k.key in LAUNCH_CALLS)
    # ms a call and launches a call, by kernel and by group
    rows = [(k.self_device_time_total / 1000.0 / TRACED_CALLS,
             k.count // TRACED_CALLS, k.key) for k in kernels]
    busy = sum(r[0] for r in rows)
    print(f"{label}: untraced {untraced:.3f} ms a call; traced "
          f"{window:.3f} ms a call, {launched // TRACED_CALLS} launches a "
          f"call by the host, {sum(r[1] for r in rows)} kernels a call in "
          f"the device trace, device busy {busy:.3f} ms = "
          f"{100 * busy / window:.1f}% of the traced call, "
          f"{100 * busy / untraced:.1f}% of the untraced one [{card}]")
    groups = defaultdict(lambda: [0.0, 0])
    for ms, n, key in rows:
        groups[group_of(key)][0] += ms
        groups[group_of(key)][1] += n
    print("device time by group (ms a call, share of busy, launches):")
    for name, (ms, n) in sorted(groups.items(), key=lambda g: -g[1][0]):
        print(f"  {ms:9.3f}  {100 * ms / busy:5.1f}%  {n:5d}  {name}")
    print("top kernels (ms a call, launches, name):")
    for ms, n, key in sorted(rows, key=lambda r: -r[0])[:25]:
        print(f"  {ms:9.3f}  {n:5d}  {key[:110]}")


DETR_YAMLS = {"DETR": "detr_256_6_6_r50.yaml",
              "AnchorDETR": "anchordetr_r50.yaml"}
DETR_TRAIN_BATCH = 8
KPTS_YAML = "yolox_kpts_swin.yaml"


def serving(dev, model_name: str):
    """(forward, postprocess) of YOLOX-s's ``Predictor``, of YOLOV7, of
    SparseInst, of DETR, of AnchorDETR or of YOLOX-KPTS (its model as
    ``forward.model``)."""
    if model_name == "YOLOX-KPTS":
        from chip_smoke import kpts_cfg, kpts_tail

        kcfg = kpts_cfg(KPTS_YAML)
        kmodel = build_model(kcfg, dev, 0)

        @torch.inference_mode()
        def kpts_forward(x):
            return kmodel(x)

        kpts_forward.model = kmodel
        return kpts_forward, lambda out: kpts_tail(out, kcfg)
    if model_name in DETR_YAMLS:
        from chip_smoke import detr_cfg, detr_tail

        dcfg = detr_cfg(DETR_YAMLS[model_name])
        dmodel = build_model(dcfg, dev, 0)

        @torch.inference_mode()
        def detr_forward(x):
            return dmodel(x)

        return detr_forward, lambda out: detr_tail(out, dcfg)
    if model_name == "SparseInst":
        scfg = SparseInstConfig()
        smodel = build_model(scfg, dev, 0)

        @torch.inference_mode()
        def si_forward(x):
            return smodel(x)

        @torch.inference_mode()
        def si_postprocess(out):
            return si.sparseinst_postprocess(
                out, scfg.cls_threshold, scfg.mask_threshold,
                scfg.max_detections)

        return si_forward, si_postprocess
    if model_name == "YOLOX-s":
        predictor = Predictor(YoloxConfig(), device=dev, seed=0)
        return predictor.forward, predictor.postprocess
    cfg = AnchorYoloConfig()
    model = build_model(cfg, dev, 0)

    @torch.inference_mode()
    def forward(x):
        return model(x)

    @torch.inference_mode()
    def postprocess(head):
        return anchor_yolo_postprocess(
            head, "yolov7", cfg.conf_threshold, cfg.nms_threshold,
            cfg.max_detections, cfg.pre_nms_topk)

    return forward, postprocess


def profile_train_sparseinst(card: str, dev, gen) -> None:
    """SparseInst's step through ``build_system``; then the matcher alone
    on the outputs of that batch (CUDA events over 10 calls after 3)."""
    from chip_smoke import inseg_batch

    _, state, train_step, _ = build_system(SparseInstConfig(), device=dev,
                                           seed=0)
    batch = inseg_batch(TRAIN_BATCH, gen, dev)

    def one_step():
        nonlocal state
        state, metrics = train_step(state, batch)
        return metrics

    rounds = int(one_step()["match_iters"])
    trace(one_step, card, f"SparseInst train step bs {TRAIN_BATCH}")
    with torch.no_grad():
        out = state.model(batch["image"])
        small = si._resize(batch["gt_masks"].float(),
                           out["mask_logits"].shape[-2:])
    ms = cuda_ms(lambda: si.sparseinst_match(out, small, batch["gt_classes"],
                                             batch["gt_valid"]))
    _, _, iters = si.sparseinst_match(out, small, batch["gt_classes"],
                                      batch["gt_valid"])
    print(f"auction matcher alone: {ms:.3f} ms a call, rounds an image "
          f"{iters.tolist()} (the first step's batch: {rounds}) [{card}]")


def profile_train_detr(card: str, dev, gen, model_name: str) -> None:
    """DETR's or AnchorDETR's step through ``build_system``; then the
    stacked six-level auction alone on the outputs of that batch (CUDA
    events over 10 calls after 3)."""
    from chip_smoke import detr_batch, detr_cfg, level_assignments

    cfg = detr_cfg(DETR_YAMLS[model_name])
    _, state, train_step, _ = build_system(cfg, device=dev, seed=0)
    batch = detr_batch(DETR_TRAIN_BATCH, gen, dev, cfg.input_size[0])

    def one_step():
        nonlocal state
        state, metrics = train_step(state, batch)
        return metrics

    rounds = int(one_step()["match_iters"])
    trace(one_step, card, f"{model_name} train step bs {DETR_TRAIN_BATCH}")
    with torch.no_grad():
        out = state.model(batch["image"])
    ms = cuda_ms(lambda: level_assignments(out, batch, cfg))
    print(f"six-level auction alone: {ms:.3f} ms a call (the first step's "
          f"rounds: {rounds}) [{card}]")


def window_attention_alone(card: str, dev, model, bs: int) -> None:
    """Each Swin stage's window attention at ``bs`` images of 640: the
    port's matmuls and float32 softmax against SDPA with the same additive
    bias and mask, CUDA events over 10 calls after 3, bf16 under
    autocast."""
    import torch.nn.functional as F

    from yolov7_d2_tpu_torch.models.backbones import swin

    total = {"port": 0.0, "sdpa": 0.0}
    side = 640 // 4
    for s, stage in enumerate(model.backbone.layers):
        blocks = stage.blocks
        attn = blocks[1].attn if len(blocks) > 1 else blocks[0].attn
        ws = blocks[0].window_size
        hp = -(-side // ws) * ws
        nw = (hp // ws) ** 2
        dim = attn.qkv.in_features
        x = torch.randn((bs * nw, ws * ws, dim), device=dev,
                        dtype=torch.bfloat16)
        mask = swin._shift_mask(hp, hp, ws, ws // 2, dev)
        heads, n = attn.num_heads, ws * ws

        def sdpa():
            qkv = attn.qkv(x).reshape(bs * nw, n, 3, heads, -1).permute(
                2, 0, 3, 1, 4)
            bias = attn.relative_position_bias_table[
                attn.relative_position_index.reshape(-1)].reshape(
                    n, n, heads).permute(2, 0, 1)
            m = (bias[None] + mask[:, None]).to(qkv.dtype)  # [nW, h, n, n]
            out = F.scaled_dot_product_attention(
                qkv[0].reshape(bs, nw, heads, n, -1),
                qkv[1].reshape(bs, nw, heads, n, -1),
                qkv[2].reshape(bs, nw, heads, n, -1), attn_mask=m)
            return attn.proj(out.reshape(bs * nw, heads, n, -1)
                             .transpose(1, 2).reshape(bs * nw, n, -1))

        with torch.inference_mode(), torch.autocast(
                torch.device(dev).type, dtype=torch.bfloat16):
            port_ms = cuda_ms(lambda: attn(x, mask))
            sdpa_ms = cuda_ms(sdpa)
        total["port"] += port_ms * len(blocks)
        total["sdpa"] += sdpa_ms * len(blocks)
        print(f"stage {s} window attention, bs {bs}: {bs * nw} windows x "
              f"{heads} heads x {n}x{n}, dim {dim}: port {port_ms:.3f} ms, "
              f"SDPA {sdpa_ms:.3f} ms a block, {len(blocks)} blocks "
              f"[{card}]", flush=True)
        side //= 2
    print(f"window attention of the whole backbone, bs {bs}: port "
          f"{total['port']:.3f} ms, SDPA {total['sdpa']:.3f} ms [{card}]")


def profile_train_kpts(card: str, dev, gen) -> None:
    """YOLOX-KPTS's (Swin-T) step through ``build_system`` on 16 images;
    then SimOTA alone on the step's outputs (CUDA events over 10 calls
    after 3)."""
    from chip_smoke import kpts_batch, kpts_cfg

    from yolov7_d2_tpu_torch.models.heads.yolox_head import (
        decode_outputs,
        simota_assign,
    )

    _, state, train_step, _ = build_system(kpts_cfg(KPTS_YAML), device=dev,
                                           seed=0)
    batch = kpts_batch(TRAIN_BATCH, gen, dev)

    def one_step():
        nonlocal state
        state, metrics = train_step(state, batch)
        return metrics

    one_step()
    trace(one_step, card, f"YOLOX-KPTS Swin-T train step bs {TRAIN_BATCH}")
    with torch.no_grad():
        out = state.model(batch["image"])
        boxes, obj, cls = decode_outputs(out["outputs"], out["grids"],
                                         out["strides"])

        def assign():
            return simota_assign(boxes, obj, cls, out["grids"],
                                 out["strides"], batch["gt_boxes"],
                                 batch["gt_classes"], batch["gt_valid"])

        ms = cuda_ms(assign)
        fg = int(assign()["num_fg"].sum())
    print(f"SimOTA alone over {boxes.shape[1]} anchors, {TRAIN_BATCH} "
          f"images, 100 gt slots: {ms:.3f} ms a call, {fg} foreground "
          f"anchors [{card}]")


def profile_train(card: str, dev, gen, yolov7: bool) -> None:
    if yolov7:
        cfg = dataclasses.replace(AnchorYoloConfig(), grid_mask=True,
                                  ema=True)
        _, state, train_step, _ = build_system(cfg, device=dev, seed=0)
    else:
        cfg = dataclasses.replace(YoloxConfig(), grid_mask=True)
        _, state, train_step = build_yolox_system(cfg, device=dev, seed=0)
    step = make_packed_photo_step(cfg, train_step, seed=0)
    n, g = TRAIN_BATCH, cfg.max_boxes
    xy = torch.rand((n, g, 2), generator=gen) * 632
    boxes = torch.cat([xy, (xy + 8 + torch.rand((n, g, 2), generator=gen)
                            * 312).clamp(max=640)], -1)
    valid = torch.arange(g)[None] < torch.randint(1, g + 1, (n, 1),
                                                  generator=gen)
    batch = {k: v.to(dev) for k, v in {
        "image": torch.randint(0, 256, (n, 640, 640, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": boxes * valid[..., None],
        "gt_classes": torch.randint(0, 80, (n, g), generator=gen,
                                    dtype=torch.int32) * valid,
        "gt_valid": valid}.items()}

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    trace(one_step, card, f"train step bs {n}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true",
                        help="profile the training step instead of serving")
    parser.add_argument("--yolov7", action="store_true",
                        help="YOLOV7 (configs/coco/yolov7.yaml) for YOLOX-s")
    parser.add_argument("--sparseinst", action="store_true",
                        help="SparseInst R-50 (sparse_inst_r50_base.yaml)")
    parser.add_argument("--detr", action="store_true",
                        help="DETR R-50 (detr_256_6_6_r50.yaml) at 800")
    parser.add_argument("--anchordetr", action="store_true",
                        help="AnchorDETR R-50 (anchordetr_r50.yaml) at 800")
    parser.add_argument("--yolox-kpts", action="store_true",
                        help="YOLOX-KPTS on Swin-T (yolox_kpts_swin.yaml)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_port: no CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    name = ("SparseInst" if args.sparseinst else
            "YOLOV7" if args.yolov7 else "DETR" if args.detr else
            "AnchorDETR" if args.anchordetr else
            "YOLOX-KPTS" if args.yolox_kpts else "YOLOX-s")
    size = 800 if name in DETR_YAMLS else 640
    print(f"model: {name} {size} bf16", flush=True)
    if args.train and name in DETR_YAMLS:
        profile_train_detr(card, dev, gen, name)
        return 0
    if args.train and args.yolox_kpts:
        profile_train_kpts(card, dev, gen)
        return 0
    if args.train and args.sparseinst:
        profile_train_sparseinst(card, dev, gen)
        return 0
    if args.train:
        profile_train(card, dev, gen, args.yolov7)
        return 0
    forward, postprocess = serving(dev, name)

    for bs in BATCHES:
        x = torch.randint(0, 256, (bs, size, size, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        e2e = cuda_ms(lambda: postprocess(forward(x)))
        fwd = cuda_ms(lambda: forward(x))
        head = forward(x)
        tail = cuda_ms(lambda: postprocess(head))
        print(f"bs {bs}: e2e {e2e:.3f} ms ({bs * 1000 / e2e:.1f} img/s), "
              f"forward {fwd:.3f} ms, tail {tail:.3f} ms [{card}]",
              flush=True)

    bs = max(BATCHES)
    x = torch.randint(0, 256, (bs, size, size, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    trace(lambda: postprocess(forward(x)), card, f"bs {bs}")
    if name == "YOLOX-KPTS":
        del x
        window_attention_alone(card, dev, forward.model, bs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
