#!/usr/bin/env python3
"""Where the time of the PyTorch port's YOLOX-s serving path, or of its
training step, goes on one CUDA card; with ``--yolov7``, YOLOV7's; with
``--sparseinst``, SparseInst R-50's; with ``--detr`` / ``--anchordetr``,
DETR R-50's / AnchorDETR R-50's; with ``--yolox-kpts``, YOLOX-KPTS on
Swin-T's; with ``--yolov5`` / ``--yolov6`` / ``--yolof``, YOLOv5-s's,
YOLOv6-s's or YOLOF R-50's; with ``--yolox-convnext``, YOLOX on
ConvNeXt-T's; with ``--smca``, SMCA-DETR R-50's; with ``--res2net``,
YOLOV7 on Res2Net-50's; with ``--sparseinst-dcn``, SparseInst
R-50-DCN's; with ``--solov2``, SOLOv2 R-50's; with ``--mask-rcnn`` /
``--panoptic``, Mask R-CNN R-50-FPN's / Panoptic FPN's.

    python3 tools/profile_torch_port.py            # serving
    python3 tools/profile_torch_port.py --train    # training step
    python3 tools/profile_torch_port.py --yolov7 [--train]
    python3 tools/profile_torch_port.py --sparseinst [--train]
    python3 tools/profile_torch_port.py --detr | --anchordetr [--train]
    python3 tools/profile_torch_port.py --yolox-kpts [--train]
    python3 tools/profile_torch_port.py --yolov5 | --yolov6 | --yolof [--train]
    python3 tools/profile_torch_port.py --yolox-convnext | --smca | \
        --res2net [--train]
    python3 tools/profile_torch_port.py --sparseinst-dcn | --solov2 [--train]
    python3 tools/profile_torch_port.py --mask-rcnn | --panoptic [--train]

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
outputs. YOLOv5-s (``configs/coco/yolov5_s.yaml``), YOLOv6-s
(``yolov6_s.yaml``) at 640 and YOLOF R-50 (``yolof/yolof_R_50_DC5_1x.yaml``)
at 800: serving through ``build_model`` and the family's tail
(``chip_smoke.onestage_tail``); training through ``build_system`` (EMA on)
on 16 images, YOLOv5 and YOLOv6 in ``make_packed_photo_step`` with GridMask
on, YOLOF on the uint8 batch, and the loss's assignment alone on the step's
outputs (SimOTA over all anchors for YOLOv6, the uniform matcher for
YOLOF). YOLOX on ConvNeXt-T (``configs/coco/yolox/yolox_convnext.yaml``)
at 800: serving through ``Predictor``, the step as YOLOX-s's (16 images,
GridMask on, drop path from the step). SMCA-DETR R-50
(``configs/coco/detr/smca_detr_r50.yaml``) at 800: as DETR. YOLOV7 on
Res2Net-50 v1b (``configs/coco/r2_50.yaml``) at 640: as YOLOV7.
SparseInst R-50-DCN (``sparseinst/sparse_inst_r50_dcn_giam_aug.yaml``) at
608: as SparseInst, and after the serving trace each DCNv2 layer alone at
bs 128 on the input it took in one forward (CUDA events): their sum and
its share of the traced busy time. SOLOv2 R-50 (``solov2/solov2_r50.yaml``)
at 640: serving through ``build_model`` and ``solov2_postprocess``;
training through ``build_system`` on 16 images with 100 mask slots and
their boxes (1-20 valid). Every line carries the card's name and power
limit. Imports no JAX.
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

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

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
    config_from_yaml,
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
    ("batch norm", r"batch_norm|batchnorm|bn_fw"),
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
    ("deformable sampling (grid_sample)", r"grid_sampler"),
    ("fixed-order sums (segment_reduce)", r"segment_reduce"),
    ("gathers (RoIAlign, top-k rows)", r"index_select|gather|index_kernel"),
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


def trace(fn, card: str, label: str) -> float:
    """Time ``fn`` untraced, then trace TRACED_CALLS calls and print the
    report. The profiler slows the host, so the busy share is given of
    both the traced window and the untraced call. The kernels the device
    trace holds are counted against the host's launch calls: on the H100
    machine used so far the trace of a training step held about 1240 of
    its 1955 launches (no SiLU or cast kernel), so its busy time is then a
    lower bound. Returns the device's busy ms a call."""
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
    return busy


DETR_YAMLS = {"DETR": "detr_256_6_6_r50.yaml",
              "AnchorDETR": "anchordetr_r50.yaml",
              "SMCA-DETR": "smca_detr_r50.yaml"}
# YOLOX on a zoo backbone, YOLOV7 on Res2Net (under configs/coco)
ZOO_YOLOX_YAML = "yolox/yolox_convnext.yaml"
RES2NET_YAML = "r2_50.yaml"
ONESTAGE_YAMLS = {"YOLOv5-s": "yolov5_s.yaml", "YOLOv6-s": "yolov6_s.yaml",
                  "YOLOF R-50": "yolof/yolof_R_50_DC5_1x.yaml"}
DETR_TRAIN_BATCH = 8
KPTS_YAML = "yolox_kpts_swin.yaml"


DCN_YAML = "sparseinst/sparse_inst_r50_dcn_giam_aug.yaml"
SOLOV2_YAML = "solov2/solov2_r50.yaml"
# the R-CNN family's LazyConfig files and sizes (chip_smoke.py section 21)
RCNN_FILES = {"Mask R-CNN": ("new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py",
                             1024),
              "Panoptic FPN": ("new_baselines/panoptic_fpn_regnetx_0.4g.py",
                               640)}


def coco_cfg(yaml: str):
    """The config dataclass of ``configs/coco/<yaml>``'s architecture."""
    return config_from_yaml(os.path.join(REPO, "configs", "coco", yaml))


def serving(dev, model_name: str):
    """(forward, postprocess) of YOLOX-s's ``Predictor``, of YOLOV7, of
    SparseInst, of DETR, of AnchorDETR or of YOLOX-KPTS (its model as
    ``forward.model``)."""
    if model_name in ONESTAGE_YAMLS:
        from chip_smoke import onestage_tail

        ocfg = coco_cfg(ONESTAGE_YAMLS[model_name])
        omodel = build_model(ocfg, dev, 0)

        @torch.inference_mode()
        def onestage_forward(x):
            return omodel(x)

        return onestage_forward, lambda out: onestage_tail(out, ocfg)
    if model_name == "YOLOX-KPTS":
        from chip_smoke import kpts_tail

        kcfg = coco_cfg(KPTS_YAML)
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
    if model_name == "SOLOv2":
        vcfg = coco_cfg(SOLOV2_YAML)
        vmodel = build_model(vcfg, dev, 0)

        @torch.inference_mode()
        def solov2_forward(x):
            return vmodel(x)

        @torch.inference_mode()
        def solov2_postprocess(out):
            from yolov7_d2_tpu_torch.models.meta_arch.solov2 import (
                solov2_postprocess as tail,
            )

            return tail(out)

        return solov2_forward, solov2_postprocess
    if model_name in ("SparseInst", "SparseInst-DCN"):
        scfg = (SparseInstConfig() if model_name == "SparseInst"
                else coco_cfg(DCN_YAML))
        smodel = build_model(scfg, dev, 0)

        @torch.inference_mode()
        def si_forward(x):
            return smodel(x)

        @torch.inference_mode()
        def si_postprocess(out):
            return si.sparseinst_postprocess(
                out, scfg.cls_threshold, scfg.mask_threshold,
                scfg.max_detections)

        si_forward.model = smodel
        return si_forward, si_postprocess
    if model_name in ("YOLOX-s", "YOLOX ConvNeXt-T"):
        predictor = Predictor(
            YoloxConfig() if model_name == "YOLOX-s"
            else coco_cfg(ZOO_YOLOX_YAML), device=dev, seed=0)
        return predictor.forward, predictor.postprocess
    cfg = AnchorYoloConfig()
    if model_name == "YOLOV7 Res2Net-50":
        cfg = coco_cfg(RES2NET_YAML)
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


def rcnn_serving(dev, model_name: str):
    """(forward, postprocess) of the R-CNN family's file at bf16
    (``chip_smoke.lazy_rcnn_model``): ``mask_rcnn_postprocess``, and for
    Panoptic FPN the semantic logits' argmax as well."""
    from chip_smoke import lazy_rcnn_model

    from yolov7_d2_tpu_torch.models.meta_arch.mask_rcnn import (
        mask_rcnn_postprocess,
    )

    model, _ = lazy_rcnn_model(RCNN_FILES[model_name][0], dev)

    @torch.inference_mode()
    def forward(x):
        return model(x)

    @torch.inference_mode()
    def postprocess(out):
        dets = mask_rcnn_postprocess(out)
        if "sem_seg_logits" in out:
            return dets, out["sem_seg_logits"].argmax(-1)
        return dets

    return forward, postprocess


def profile_train_rcnn(card: str, dev, gen, model_name: str) -> None:
    """``build_system``'s step (sampled mode, bf16) of 16 images of the
    R-CNN file's architecture (``chip_smoke.rcnn_train_cfg``) on the
    batch of ``chip_smoke.rcnn_batch`` (GTs on the serving proposals)."""
    from chip_smoke import lazy_rcnn_model, rcnn_batch, rcnn_train_cfg

    name, size = RCNN_FILES[model_name]
    cfg = rcnn_train_cfg(name, size)
    _, state, step, fields = build_system(cfg, device=dev, seed=0)
    model, _ = lazy_rcnn_model(name, dev)
    batch = rcnn_batch(TRAIN_BATCH, gen, dev, size, model, fields)
    del model

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    trace(one_step, card, f"train step bs {TRAIN_BATCH}")


def dcn_alone(card: str, forward, x, busy_ms: float) -> None:
    """Each DCNv2 layer of ``forward.model`` alone on the input it took in
    one forward of ``x`` (CUDA events, 10 calls after 3), and their sum
    against ``busy_ms``, the device's busy time of a call."""
    from yolov7_d2_tpu_torch.ops.deform_conv import DeformConv

    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append((mod, args[0])))
        for m in forward.model.modules() if isinstance(m, DeformConv)]
    forward(x)
    for h in hooks:
        h.remove()
    total = 0.0
    with torch.inference_mode():
        for mod, inp in inputs:
            ms = cuda_ms(lambda: mod(inp))
            total += ms
            print(f"  DCNv2 on {tuple(inp.shape)} {inp.dtype}: {ms:.3f} ms")
    print(f"DCNv2 layers alone: {len(inputs)} layers, {total:.3f} ms a "
          f"forward = {100 * total / busy_ms:.1f}% of the traced busy "
          f"{busy_ms:.3f} ms [{card}]")


def profile_train_sparseinst(card: str, dev, gen, cfg=None,
                             size: int = 640) -> None:
    """SparseInst's step through ``build_system`` (``cfg``: R-50 by
    default); then the matcher alone on the outputs of that batch (CUDA
    events over 10 calls after 3)."""
    from chip_smoke import inseg_batch

    _, state, train_step, _ = build_system(cfg or SparseInstConfig(),
                                           device=dev, seed=0)
    batch = inseg_batch(TRAIN_BATCH, gen, dev, size)

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


def profile_train_solov2(card: str, dev, gen) -> None:
    """SOLOv2's step through ``build_system`` on 16 images with masks and
    boxes."""
    from chip_smoke import mask_batch

    _, state, train_step, fields = build_system(coco_cfg(SOLOV2_YAML),
                                                device=dev, seed=0)
    batch = {k: v for k, v in mask_batch(TRAIN_BATCH, gen, dev).items()
             if k in fields}

    def one_step():
        nonlocal state
        state, metrics = train_step(state, batch)
        return metrics

    trace(one_step, card, f"SOLOv2 train step bs {TRAIN_BATCH}")


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
    from chip_smoke import kpts_batch

    from yolov7_d2_tpu_torch.models.heads.yolox_head import (
        decode_outputs,
        simota_assign,
    )

    _, state, train_step, _ = build_system(coco_cfg(KPTS_YAML), device=dev,
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


def profile_train_onestage(card: str, dev, gen, model_name: str) -> None:
    """The step of YOLOv5-s, YOLOv6-s or YOLOF R-50 through
    ``build_system`` (EMA on) on 16 images of 100 box slots (1-100 valid);
    then the loss's assignment alone on the step's outputs."""
    from chip_smoke import onestage_assignment, train_batch

    cfg = dataclasses.replace(coco_cfg(ONESTAGE_YAMLS[model_name]),
                              ema=True)
    is_yolof = cfg.meta_architecture == "YOLOF"
    if not is_yolof:
        cfg = dataclasses.replace(cfg, grid_mask=True)
    model, state, train_step, _ = build_system(cfg, device=dev, seed=0)
    step = (train_step if is_yolof
            else make_packed_photo_step(cfg, train_step, seed=0))
    batch = {k: v.to(dev) for k, v in train_batch(
        TRAIN_BATCH, gen, cfg.input_size[0]).items()}

    def one_step():
        nonlocal state
        state, _ = step(state, batch)

    trace(one_step, card, f"train step bs {TRAIN_BATCH}")
    if cfg.meta_architecture == "YOLOV5":
        return
    fbatch = dict(batch, image=batch["image"].float())
    ms = cuda_ms(lambda: onestage_assignment(model, cfg, fbatch))
    with torch.no_grad():
        fwd = cuda_ms(lambda: model.train()(fbatch["image"]))
    model.eval()
    print(f"train-mode forward and the loss's assignment: {ms:.3f} ms, of "
          f"which the forward {fwd:.3f} ms ({TRAIN_BATCH} images) [{card}]")


def profile_train(card: str, dev, gen, name: str) -> None:
    """The step of 16 images with GridMask on of YOLOX-s, YOLOX on
    ConvNeXt-T (``build_yolox_system``), YOLOV7 or YOLOV7 on Res2Net-50
    (``build_system``, EMA on), in ``make_packed_photo_step``."""
    if name.startswith("YOLOV7"):
        cfg = (AnchorYoloConfig() if name == "YOLOV7"
               else coco_cfg(RES2NET_YAML))
        cfg = dataclasses.replace(cfg, grid_mask=True, ema=True)
        _, state, train_step, _ = build_system(cfg, device=dev, seed=0)
    else:
        cfg = (YoloxConfig() if name == "YOLOX-s"
               else coco_cfg(ZOO_YOLOX_YAML))
        cfg = dataclasses.replace(cfg, grid_mask=True)
        _, state, train_step = build_yolox_system(cfg, device=dev, seed=0)
    step = make_packed_photo_step(cfg, train_step, seed=0)
    n, g, size = TRAIN_BATCH, cfg.max_boxes, cfg.input_size[0]
    xy = torch.rand((n, g, 2), generator=gen) * (size - 8)
    boxes = torch.cat([xy, (xy + 8 + torch.rand((n, g, 2), generator=gen)
                            * (size // 2 - 8)).clamp(max=size)], -1)
    valid = torch.arange(g)[None] < torch.randint(1, g + 1, (n, 1),
                                                  generator=gen)
    batch = {k: v.to(dev) for k, v in {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
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
    parser.add_argument("--yolov5", action="store_true",
                        help="YOLOv5-s (yolov5_s.yaml)")
    parser.add_argument("--yolov6", action="store_true",
                        help="YOLOv6-s (yolov6_s.yaml)")
    parser.add_argument("--yolof", action="store_true",
                        help="YOLOF R-50 (yolof_R_50_DC5_1x.yaml) at 800")
    parser.add_argument("--yolox-convnext", action="store_true",
                        help="YOLOX on ConvNeXt-T (yolox/yolox_convnext.yaml)"
                        " at 800")
    parser.add_argument("--smca", action="store_true",
                        help="SMCA-DETR R-50 (smca_detr_r50.yaml) at 800")
    parser.add_argument("--res2net", action="store_true",
                        help="YOLOV7 on Res2Net-50 (r2_50.yaml)")
    parser.add_argument("--sparseinst-dcn", action="store_true",
                        help="SparseInst R-50-DCN "
                        "(sparse_inst_r50_dcn_giam_aug.yaml) at 608")
    parser.add_argument("--solov2", action="store_true",
                        help="SOLOv2 R-50 (solov2_r50.yaml)")
    parser.add_argument("--mask-rcnn", action="store_true",
                        help="Mask R-CNN R-50-FPN "
                        "(mask_rcnn_R_50_FPN_100ep_LSJ.py) at 1024")
    parser.add_argument("--panoptic", action="store_true",
                        help="Panoptic FPN (panoptic_fpn_regnetx_0.4g.py) at"
                        " 640")
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
            "YOLOX-KPTS" if args.yolox_kpts else
            "YOLOv5-s" if args.yolov5 else "YOLOv6-s" if args.yolov6 else
            "YOLOF R-50" if args.yolof else
            "YOLOX ConvNeXt-T" if args.yolox_convnext else
            "SMCA-DETR" if args.smca else
            "YOLOV7 Res2Net-50" if args.res2net else
            "SparseInst-DCN" if args.sparseinst_dcn else
            "SOLOv2" if args.solov2 else
            "Mask R-CNN" if args.mask_rcnn else
            "Panoptic FPN" if args.panoptic else "YOLOX-s")
    size = 800 if name in DETR_YAMLS or name in (
        "YOLOF R-50", "YOLOX ConvNeXt-T") else (
        608 if name == "SparseInst-DCN" else
        RCNN_FILES[name][1] if name in RCNN_FILES else 640)
    print(f"model: {name} {size} bf16", flush=True)
    if args.train and name in ONESTAGE_YAMLS:
        profile_train_onestage(card, dev, gen, name)
        return 0
    if args.train and name in DETR_YAMLS:
        profile_train_detr(card, dev, gen, name)
        return 0
    if args.train and args.yolox_kpts:
        profile_train_kpts(card, dev, gen)
        return 0
    if args.train and args.sparseinst:
        profile_train_sparseinst(card, dev, gen)
        return 0
    if args.train and args.sparseinst_dcn:
        profile_train_sparseinst(card, dev, gen, coco_cfg(DCN_YAML), size)
        return 0
    if args.train and args.solov2:
        profile_train_solov2(card, dev, gen)
        return 0
    if args.train and name in RCNN_FILES:
        profile_train_rcnn(card, dev, gen, name)
        return 0
    if args.train:
        profile_train(card, dev, gen, name)
        return 0
    forward, postprocess = (rcnn_serving(dev, name) if name in RCNN_FILES
                            else serving(dev, name))

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
    busy = trace(lambda: postprocess(forward(x)), card, f"bs {bs}")
    if name == "SparseInst-DCN":
        dcn_alone(card, forward, x, busy)
    if name == "YOLOX-KPTS":
        del x
        window_attention_alone(card, dev, forward.model, bs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
