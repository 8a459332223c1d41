#!/usr/bin/env python3
"""Smoke run of the PyTorch port's YOLOX-s serving path, training step,
training CLI and multi-GPU training, of the anchor-YOLO family's serving
and training, of SparseInst's and of DETR's and AnchorDETR's serving,
training, CLI and multi-GPU training, of YOLOX-KPTS's serving, training
and eval, of the one-stage box detectors' (YOLOv5, YOLOv6, YOLOF, BiFPN
and PAN necks), of YOLOV7 on Res2Net, of the backbone zoo (RegNet,
ConvNeXt, EfficientNet, FBNet) and of SMCA-DETR, DAB-DETR and the d2go
DETR serving and training, of SparseInst R-50-DCN, YOLOX on DLA, SOLOv2,
YOLOMask and DetrSegm serving and training, of LazyConfig, Mask R-CNN,
Faster R-CNN and Panoptic FPN serving and training, of the repeatability
of a training step, of the library NMS suite, one train step of every
yaml of ``configs/``, of deploy (the exported program with the NMS
kernel in it, int8, pruning) and the rest of the feed, and of YOLOX-s
trained on a (data, model) grid with its widest parameters sharded over
the model axis, on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``yolov7_d2_tpu_torch/csrc`` and holds
each against its plain PyTorch version at its path's shapes (NMS also on a
one-class case that suppresses heavily, GridMask on float32 and uint8).
Then the paths, full-width YOLOX-s (80 classes, 640 px, bf16 over f32
weights, random weights from a seed), each with the kernel launch counts
set to 0 just before it and read just after:

* serving: ``Predictor.predict_batch`` for requests of 1, 8 and 128
  images (normalize and NMS kernels), outputs checked, kernel path against
  plain path, the card against the CPU, times by CUDA events;
* training: ``build_yolox_system`` + ``make_packed_photo_step`` with
  GridMask on, 13 steps of 16 seeded uint8 images (mixup, GridMask
  kernel on float32, flip, forward, SimOTA and losses, backward, SGD,
  EMA), checked for finite losses, foreground anchors and moving weights,
  EMA and BN statistics; ms a step, img/s and peak memory;
* training with mixup off: 3 steps, the images uint8 through the GridMask
  kernel and the normalize kernel, checked for finite losses and moving
  weights; then one float32 step on the card against the CPU;
* the CLI: ``train_det.main`` on ``configs/coco/yolox_s.yaml`` and a
  synthetic mini-COCO of 64 JPEGs (640x480, 1-8 boxes each): the host
  mosaic feed for 12 steps (checkpoints at 6 and 12, the COCO eval at 12
  through the normalize and NMS kernels) and ``--resume`` to 16; the
  packed feed (shards written by the port's writers) with GridMask until
  step 8 and the plain shards after it; the device geometry feed (the
  tile loader, ``DeviceAug`` in the step) with GridMask for 12 steps and
  the COCO eval at 12; the loaders alone, the eval and a checkpoint save
  timed;
* multi-GPU training (``parallel/``): (a) two ranks on one card over gloo
  (``launch(..., backend="gloo")``), the bare float32 step, 2 images a
  rank for 2 steps, against one process on the same 4 images (fg counts,
  losses and gradient norm, ranks bitwise equal, kernel launches a step);
  (b) the CLI's packed feed, 6 steps with GridMask until step 4 and the
  COCO eval at 6 on rank 0, inside an NCCL group of 1 (DDP) against no
  group: losses, the two ms-a-step medians, and the on-card step in turns
  with and without the group; (c) where two or more cards are visible, N
  of them (up to 4) over NCCL: the bare step against one process as in
  (a), then ``--num-gpus N`` through the CLI (logged as skipped on one
  card). The
  kernels' launches in the JSON line are those of (b) (GridMask on its
  steps before DISABLE_AT_ITER, normalize on the plain steps and in the
  eval, NMS in the eval) and of the CLI's run C (GridMask every step,
  normalize and NMS in the eval); the uint8 GridMask's are the mixup-off path's;
  ``normalize_sparseinst``'s are the sum of SparseInst's serving (b) and
  training (d) paths below;
* the anchor-YOLO family (``anchor_yolo_phase``): YOLOV7 at 640 from
  ``configs/coco/yolov7.yaml``, full depth and width (CSP-Darknet53,
  YOLOPAFPN, the anchor head), bf16 over f32 weights from the seed.
  Serving: ``build_model`` + ``anchor_yolo_postprocess`` for requests of
  1, 8 and 128 images (normalize and NMS kernels, their launches counted
  from 0), the kernel path against the plain one index for index at bs
  128, the f32 head outputs on the card against the CPU at bs 1 within
  1e-4 of the max, times by CUDA events. Training: ``build_system``'s step
  in ``make_packed_photo_step``, GridMask (mode 1, prob 0.3) and mixup on,
  EMA on, 6 steps of 16 images (finite losses, foreground anchors,
  weights, EMA and BN statistics moved, ms a step, peak memory, GridMask
  launches), then one f32 step (128 px, 2 images) on the card against the
  CPU within 1e-3 with the same fg count. Then one request and one train
  step each for ``YOLO`` (``configs/coco/darknet53.yaml``), ``YOLOV7P``
  (CSP-Darknet53) and ``YOLOV7P`` on ResNet-50 (``configs/coco/r50.yaml``),
  full depth;
* SparseInst R-50 (``sparseinst_phase``): ``configs/coco/sparseinst/
  sparse_inst_r50_base.yaml`` at 640, full depth and width (ResNet-50
  with FrozenBN, the FPN-PPM encoder, ``BaseIAMDecoder`` with 100 masks),
  bf16 over f32 weights from the seed. (a) the normalize kernel at
  SparseInst's ImageNet mean and std on [128,640,640,3], bit-exact (the
  ``normalize_sparseinst`` entry); (b) serving, uint8 -> normalize kernel
  -> forward -> ``sparseinst_postprocess``, for requests of 1, 8 and 128
  images (instances found, finite masks, one launch a request, times by
  CUDA events) and ``upsample_masks_two_stage`` on one request; (c) the
  f32 forward on the card against the CPU at 128 px within 1e-4 of each
  output's max; (d) 6 steps of 16 images through ``build_system``
  (AdamW, 100 dense mask slots an image): finite losses, matched
  instances, parameters moved, FrozenBN statistics unmoved, ms a step,
  peak memory, the auction's rounds a step; one f32 step on the card
  against the CPU (assignments equal, losses and grad norm within 1e-3);
  (e) ``train_inseg`` on a mini-COCO of 64 JPEGs with polygons, the blend
  mosaic on: 12 steps with checkpoints at 6 and 12, ``--resume`` to 14,
  ``--eval-only`` (``COCOMaskEvaluator``'s keys);
* DETR R-50 and AnchorDETR R-50 (``detr_phase``):
  ``configs/coco/detr/detr_256_6_6_r50.yaml`` and ``anchordetr_r50.yaml``
  at 800, full depth and width (ResNet-50 with FrozenBN, 6 + 6 layers,
  100 queries, or 300 x 3 with RCDA), bf16 over f32 weights from the seed.
  (a) the normalize kernel at DETR's mean and std on [128,800,800,3],
  bit-exact (the ``normalize_detr`` entry, whose launches are those of
  both models' serving and training paths); serving, uint8 -> normalize
  kernel -> forward -> ``detr_postprocess`` / ``anchor_detr_postprocess``,
  for requests of 1, 8 and 128 images (one launch a request, e2e, forward
  and tail by CUDA events, the device's busy share at 128) and the kernel
  path's ``Detections`` equal to the plain path's at 8; (b) f32 outputs
  on the card against the CPU at 128 px within 1e-4 of the max, bf16
  within 5e-2; (c) 6 steps of 8 images through ``build_system``: finite
  losses and matched counts equal to the valid gts at all 6 levels,
  parameters moved, FrozenBN statistics unmoved, ms a step, peak memory,
  auction rounds; one f32 step at dropout 0 on the card against the CPU
  (assignments equal at every level, losses and grad norm within 1e-3);
  (d) ``train_transformer`` (DETR) on a mini-COCO of 64 JPEGs, the crop
  branch on: 12 steps, checkpoints at 6 and 12, ``--resume`` to 14;
* YOLOX-KPTS (``yolox_kpts_phase``): ``configs/coco/yolox_kpts_swin.yaml``
  (Swin-T, YOLOPAFPN at 0.33 / 0.50, one class, 17 keypoints), then
  ``yolox_kpts.yaml`` (CSPDarknet-X) and PVTv2-b1, at 640, full depth and
  width, bf16 over f32 weights from the seed. (a) serving, uint8 ->
  normalize kernel -> forward -> ``yolox_kpts_postprocess`` -> NMS
  kernel, for requests of 1, 8 and 128 images (launches counted from 0,
  e2e, forward and tail by CUDA events, the device's busy share at 128)
  and the kernel path's ``Detections``, keypoints included, equal to the
  plain path's at 8; (b) f32 outputs and keypoints on the card against
  the CPU at 128 px within 1e-4 of the max, bf16 within 5e-2; (c) 13
  steps of 16 images through ``build_system`` on Swin-T, 1-8 persons of
  17 keypoints an image (finite losses, foreground anchors, ``loss_kpt``
  > 0, parameters moved, ms a step, peak memory), then one f32 step at
  128 px on the card against the CPU; (d) ``eval_coco`` on a mini-COCO
  of 64 JPEGs of persons with keypoints (box and ``kpt_`` keys), and
  again with ``--weights`` of a saved state dict; (e) YOLOV7 on
  ``swin_t.yaml`` and ``pvt_v2_b0.yaml``: one request and one train step
  each. The launches of (a), (c) and (d) are added to the normalize and
  NMS entries of the kernels line;
* the one-stage box detectors (``onestage_phase``): YOLOv5-s and YOLOv6-s
  at 640 (``configs/coco/yolov5_s.yaml``, ``yolov6_s.yaml``) and YOLOF
  R-50 at 800 (``yolof/yolof_R_50_DC5_1x.yaml``), full depth and width,
  bf16 over f32 weights from the seed. The normalize kernel at YOLOF's
  mean and std on [128,800,800,3], bit-exact (the ``normalize_yolof``
  entry); then for each model (a) serving through ``build_model`` and its
  tail (``anchor_yolo_postprocess`` with the v5 gate,
  ``yolox_postprocess``, ``yolof_postprocess``) for requests of 1, 8 and
  128 images (one normalize and one NMS launch a request, times, the
  device's busy share at 128), the kernel path's ``Detections`` equal to
  the plain path's at 8; (b) f32 outputs on the card against the CPU at
  128 px within 1e-4 of the max, bf16 within 5e-2; (c) 6 steps of 16
  images through ``build_system`` (YOLOv5 and YOLOv6 with mixup and
  GridMask, YOLOF on uint8 through the normalize kernel): finite losses,
  foreground, parameters, EMA and BN statistics moved, FrozenBN unmoved,
  ms a step, peak memory; (d) one f32 step against the CPU, the loss's
  assignments equal; (e) one request and one step each of YOLOv6-tiny,
  YOLOv6-m and YOLOV7 on ResNet-50 with the BiFPN and PP-YOLO PAN necks.
  Its launches are added to the normalize, normalize_yolof, NMS and
  GridMask entries.

* C.14 (``c14_phase``): the bare float32 step of YOLOX-s 640, SparseInst
  R-50 640 and DETR R-50 800 (dropout 0), 4 images, run twice from the same
  weights and batch, every module-output and parameter gradient compared
  in the backward's order: the first that differs is logged with the
  module whose gradient came just before it; then twice more with cuDNN's
  deterministic algorithms (and, for DETR, the math backend of
  ``scaled_dot_product_attention``), where every gradient and the weights
  after the step must be bitwise equal;
* multi-GPU SparseInst and DETR (section 17): SparseInst R-50 at 640 and
  DETR R-50 at 800 (dropout 0), full depth and width: (a) two gloo ranks
  on one card (``parallel.dryrun.train_steps``, DDP, the global count in
  the loss), the float32 step, 2 images a rank for 2 steps, against one
  process on the same 4 images taking the ranks' weights and assignments
  (the global ``num_inst`` / ``num_boxes`` equal, loss shares and gradient
  norm within 1e-3, ranks bitwise equal, launches a rank step); (b)
  ``train_inseg`` (blend mosaic, 16 images) and ``train_transformer`` (crop
  branch, 8 images) for 4 steps on a mini-COCO of 32 JPEGs inside an NCCL
  group of 1 against no group (losses within 1e-3, both ms-a-step
  medians), ``train_inseg --eval-only`` on rank 0; (c) ``--num-gpus N``
  through each CLI where 2 or more cards are visible (logged as skipped
  on one card). (b)'s
  normalize launches are added to the ``normalize_sparseinst`` and
  ``normalize_detr`` entries;
* YOLOV7 on Res2Net-50 (section 18, ``anchor_yolo_phase`` on
  ``configs/coco/r2_50.yaml``, full depth and width, raw pixels through
  the normalize kernel's identity form): serving at 1, 8 and 128 images
  (normalize and NMS kernels, the kernel path's ``Detections`` equal to
  the plain path's at 128), the f32 outputs on the card against the CPU at
  128 px within 1e-4 of the max; 6 steps of 16 images in
  ``make_packed_photo_step`` with mixup and GridMask on; one f32 step
  against the CPU with the same foreground count; ``r2next_50.yaml``,
  ``r2_50_l.yaml`` (768 px) and ``tl/res2net_bifpn.yaml`` one request and
  one step each. Its launches are added to the normalize, NMS and
  GridMask entries;
* the backbone zoo and the other DETR variants (section 19,
  ``zoo_phase``): (a) the normalize kernel in its identity form on
  [128,800,800,3] and the GridMask kernel on float32 [16,800,800,3],
  bit-exact (the ``normalize_800`` and ``grid_mask_800`` entries, whose
  launches are (a)'s), YOLOX on ConvNeXt-T at 800
  (``configs/coco/yolox/yolox_convnext.yaml``) through ``Predictor`` at
  1, 8 and 128 images (normalize kernel in its identity form and NMS
  kernel, the kernel path's ``Detections`` equal to the plain path's at
  128, f32 on the card against the CPU at 128 px within 1e-4 of the max,
  times and the device's busy share), 6 steps of 16 images in
  ``make_packed_photo_step`` with mixup and GridMask, one f32 step at
  drop path 0 against the CPU, the drop path's kept share at rate 0.2 in
  float32 steps on the card (within 3 standard deviations), and
  ``train_det`` for 4 steps with the COCO eval on a mini-COCO; (b)
  SMCA-DETR R-50 at 800 (``smca_detr_r50.yaml``) as section 13 does DETR,
  and ``train_transformer`` for 4 steps; (c) one request and one step
  each of YOLOX on RegNetX-400MF and ConvNeXt-T at 640, YOLOV7 on
  RegNetX-400MF, -200MF (320 px) and EfficientNet-b2 (taps at b2's stage
  ends, ROADMAP.md C.31), and of every other yaml of SMCA-DETR, DAB-DETR
  and the d2go DETR (on ResNet-50, CSPDarknet-X, FBNetV3-A; the focal
  head through its sigmoid tail). Its launches are added to the
  normalize, normalize_800, normalize_detr, NMS, GridMask and
  grid_mask_800 entries; it logs its seconds;
* deformable convolution and the last mask families (section 20,
  ``mask_phase``): (a) the normalize kernel at SparseInst's statistics on
  [128,608,608,3], bit-exact (the ``normalize_608`` entry, whose launches
  are (a)'s), SparseInst R-50-DCN GIAM at 608
  (``sparseinst/sparse_inst_r50_dcn_giam_aug.yaml``, DCNv2 in res4 and
  res5) served at 1, 8 and 128 images (masks at 1/4, times, the busy
  share), f32 against the CPU at 128 px, 6 AdamW steps of 16 (offsets off
  zero, FrozenBN statistics unmoved) and ``train_inseg`` for 4 steps with
  the blend mosaic; (b) SOLOv2 R-50 at 640 served at 1, 8 and 128 images
  (the matrix-NMS tail at the JAX defaults; once more at threshold 0 and
  ``solov2_upsample_masks`` at 1 and 8), f32 against the CPU, 6 steps of
  16 with masks and boxes; (c) one request and one step each of the vd
  DCN yamls, ``solov2_lite.yaml`` (448), YOLOX on DLA-34
  (``dla34_yolox.yaml``, ``Predictor``, the step with GridMask), the four
  YOLOMask yamls (640 and 320: the NMS kernel, the mask recovery on one
  field, the step with GridMask on the uint8 images) and DetrSegm at 800
  (the box and mask tails, a step with ``gt_masks``, ``train_transformer``
  2 steps), the kernel path's ``Detections`` equal to the plain path's on
  each. Its launches are added to the normalize, normalize_608,
  normalize_sparseinst, normalize_detr, NMS, GridMask and grid_mask_u8
  entries; it logs its seconds;
* LazyConfig and the R-CNN family (section 21, ``rcnn_phase``): (a) Mask
  R-CNN R-50-FPN from ``configs/new_baselines/
  mask_rcnn_R_50_FPN_100ep_LSJ.py`` (the port's ``LazyConfig.load`` and
  ``instantiate``, bf16) at the file's 1024: the normalize kernel at
  detectron2's BGR statistics on [128,1024,1024,3], bit-exact (the
  ``normalize_rcnn`` entry), and the NMS kernel's 2048 instance on the
  RPN's [128,1280] candidates of one forward, index-exact (``nms_rpn``);
  serving at 1, 8 and 128 images (the normalize kernel, the RPN's NMS, the
  tail's class-aware NMS), both NMS calls against the plain version at
  128, times and the busy share; f32 against the CPU at 512 px; 6 steps of
  16 through ``build_system`` (sampled mode, GTs on the serving
  proposals: a box and a mask term on the first step, weights moved,
  FrozenBN statistics unmoved); one f32 step in expectation mode against
  the CPU within 1e-3; (b) Panoptic FPN from ``panoptic_fpn_regnetx_0.4g.
  py`` at 640: serving, ``combine_semantic_and_instance`` on one image, 6
  steps of 16 with ``gt_sem_seg``; (c) each of the other 16 LazyConfig
  files loaded, its model instantiated and served one request of 2 and
  one ``build_system`` step of its architecture, and FasterRCNN through
  the CfgNode; (d) ``lazyconfig_train_net`` on ``yolox_s_lazy.py`` for 4
  steps of 16 at 640 with a checkpoint, ``--resume`` for 2 more, and
  ``demo_lazyconfig`` on two mini-COCO JPEGs; (e) the float32 steps of
  SparseInst R-50-DCN (608, 4 images) and of Mask R-CNN (expectation, 4
  images at 256) twice each with cuDNN deterministic: bitwise equal (the
  DCN's fixed-order backward), or for Mask R-CNN the first difference a
  library module's. Its launches go to ``normalize_rcnn`` and
  ``nms_rpn``; it logs its seconds.
* the library remainder and the closure (section 22, ``closure_phase``):
  (a) the library NMS suite (``ops.nms``) on one image of 1000 candidates
  of 80 classes: K1 at [1, 1000] index-exact against its plain version
  (the ``nms_single`` entry), then ``nms``, ``batched_nms``,
  ``generalized_batched_nms`` in its four modes and
  ``weighted_boxes_fusion`` on the card against the CPU (the greedy ones
  launch K1 at [1, 1000]: ``nms_single``'s launches); (b) one train step
  of every yaml of ``configs/`` (109) at its full width and depth, 64 px
  (128 with BiFPN), one image, AMP off (``zoo_step.step_sweep``, as the
  JAX ``tests/test_config_zoo.py:29``): a finite ``total_loss`` and a
  moved step counter each, a line a yaml, the slowest five and the peak
  memory. Its launches go to the entries of their kernel and instance
  (``normalize``, ``nms``, ``nms_rpn``, ``grid_mask``); it logs its
  seconds.
* deploy and the rest of the feed (section 23, ``deploy_feed_phase``):
  (a) YOLOX-s 640 exported with ``torch.export`` on a float32 NHWC batch:
  by ``python -m yolov7_d2_tpu_torch.export --fuse-postprocess`` (bs 1)
  in a process of its own, then loaded and run in another fresh process
  (``--run-program``), whose K1 launch through the custom op is counted;
  here at bs 128 with the tail fused and at bs 8 without it (bf16), and
  at bs 8 both ways in float32; each program against ``Predictor``'s
  model and tail on the same batch (float32: raw outputs within 1e-4 of
  the max, ``Detections`` index-equal; bf16: raw outputs within 5e-2),
  its convolutions in the model's dtype, its ms a call beside
  ``Predictor``'s, the export's seconds; the programs' K1 launches are
  the ``nms_export`` entry's, timed through the op at [128, 1024]; (b)
  YOLOX-s's weights quantized to int8 (each element within its half
  scale), dequantized to bf16 and served at bs 128, and pruned
  (``l1_filter_prune`` 0.5) and served, the sparsity logged; (c) YOLOX on
  ResNet-50 and MobileViT, YOLOV7 on CSPResNet50d and the d2go DETR on
  Res2Net-50 (ROADMAP C.45) at their yamls' sizes: one request of 8
  through the tail and one step of 16; (d) the host mosaic through
  ``MultiProcessDataLoader`` with 4 workers against the threaded
  loader, YOLOX-s steps with the HSV distortion on (MixUp on with
  GridMask, MixUp off, MixUp off with GridMask: float32 K3) and the
  photometric stage timed beside HSV's bytes bound, and 6 steps under
  ``MultiScaleHook`` over two sizes. It logs each subsection's end.

* tensor parallelism (``parallel/mesh.py``): YOLOX-s 640 at full width
  and depth on a (2, 2) grid of 4 gloo ranks on the card, the parameters
  with 128 or more output features sharded over the model axis
  (column-parallel): (a) the float32 step, 2 images a data rank, 2 steps,
  against one process from the ranks' gathered weights (fg counts, losses
  and gradient norm within 1e-3, shards of O / 2 rows, the gathered state
  bitwise equal on every rank, a rank's share of the parameters); (b) 3
  bf16 steps with MixUp and GridMask, 8 images a data rank (finite, moved,
  the model ranks' images and replicated parameters bitwise equal; its
  GridMask launches join the ``grid_mask`` entry); (c) over NCCL where 2
  or more cards are visible.
* the device geometry feed and rematerialization (section 25,
  ``device_aug_remat_phase``): (a) ``DeviceAug`` (mosaic4, the perspective
  warp, MixUp, HSV, GridMask, flip) on 16 tiles of 640 px, its ms beside
  the packed photometric stage's and its output against the CPU's on the
  same draws (1e-3 of 255 on 99.9% of the pixels, boxes 1e-3 px); (b) 3
  bf16 YOLOX-s steps through ``make_device_aug_step``, the uint8
  passthrough at step 2 (its K3 and K2 launches join their entries); (c)
  float32 steps with ``TPU.REMAT`` / ``MODEL.DETR.REMAT`` against the step
  without (YOLOX-s of 16 at 640, DETR R-50 of 8 at 800 with dropout):
  loss, gradients and BN buffers, peak memory and ms a step of each. Run C
  of the CLI (section 9) trains on the device geometry feed.

``python3 chip_smoke.py --nccl`` runs (c) of sections 10, 17 and 24 alone,
on a machine of 2 or more cards.

Output: progress lines, then the card's name and power limit, a JSON line
of the kernels (times, launches on the path, bound, plain and library
times), and last ``{"ok": true, "device": {...}}``. Any failed phase
raises, and the script exits non-zero without that last line; so does a
run without a CUDA card or outside the repository.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time
import types

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
SIZE = 640
REQUEST_BATCHES = (1, 8, BATCH)
PIXEL_MEAN = (103.53, 116.28, 123.675)  # config/defaults.py, R-50 families
PIXEL_STD = (57.375, 57.12, 58.395)
WARMUP, ITERS = 3, 10
# the bf16 training steps of each family after YOLOX-s's (sections 11-19):
# 3 warm-up, 3 timed, as sections 20-21 take theirs
FAMILY_STEPS = 6
TRAIN_BATCH = 16  # one card's share of IMS_PER_BATCH 112 over 8 cards
CLI_IMAGES = 64  # the CLI phase's synthetic mini-COCO
CLI_DATASET = "chip_smoke_mini_coco"
COCO_KEYS = ("AP", "AP50", "AP75", "AR100")
# the H100 SXM's published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=WARMUP, iters=ITERS) -> float:
    """Mean milliseconds a call of ``fn`` by CUDA events, after warm-up."""
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


def request_timing(n: int) -> dict:
    """``cuda_ms``'s calls for a request of ``n`` images on the families'
    paths after YOLOX-s's: at the largest batch (a call of 40-670 ms) 3
    timed after 1, else the defaults."""
    return dict(warmup=1, iters=3) if n >= BATCH else {}


def kernel_ms(fn, warmup=WARMUP, iters=ITERS, host_ok=None) -> float:
    """Mean device milliseconds a call of ``fn``: the timed calls queue up
    behind a sleep kernel, so that the host's cost a call (a wrapper's
    checks, allocations and launch) is not in the time of a kernel that
    takes less. The reading counts only if the event after the sleep is
    still pending once the last call is queued; else the sleep grows, 1, 4
    and 16 ms. Where even that is short, the calls run at the host's pace:
    ``host_ok`` names a reading allowed to (a plain version's host loop),
    which is then logged as such; for any other that raises."""
    for _ in range(warmup):
        fn()
    for cycles in (2_000_000, 8_000_000, 32_000_000):  # at the H100's 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        if queued:
            return ms
    if host_ok is None:
        raise AssertionError("kernel_ms: the host could not queue the timed "
                             "calls ahead of the card")
    log(f"{host_ok}: {ms:.4f} ms at the host's pace (its calls could not be "
        "queued ahead of the card)")
    return ms


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nms_walk_pairs(scores, idx, valid, max_out) -> int:
    """IoU tests the greedy walk makes on this data: it visits the live
    candidates by (score descending, index ascending) up to the max_out-th
    kept one, or all L live ones where fewer are kept, and tests each
    visited candidate against the boxes kept before it."""
    b, k = scores.shape
    live = scores > 0
    order = torch.sort(scores.masked_fill(~live, -1.0), dim=1,
                       descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(k, device=scores.device).expand(b, k))
    pos = rank.gather(1, idx.clamp(min=0).long())  # kept ones' positions
    visited = torch.where(valid.sum(1) == max_out,
                          torch.where(valid, pos, -1).max(1).values + 1,
                          live.sum(1))
    # the kept box at position p is tested by the visited ones after it
    return int(torch.where(valid, visited[:, None] - 1 - pos, 0).sum())


def letterboxed_batch(n: int, gen: torch.Generator,
                      size: int = SIZE) -> torch.Tensor:
    """uint8 [n, size, size, 3]: random content of random size, anchored
    top-left, padded with 114 as the letterbox does."""
    batch = torch.full((n, size, size, 3), 114, dtype=torch.uint8)
    for i in range(n):
        h, w = (int(v) for v in torch.randint(size // 4, size + 1, (2,),
                                              generator=gen))
        if i % 2:
            h = size
        else:
            w = size
        batch[i, :h, :w] = torch.randint(0, 256, (h, w, 3), generator=gen,
                                         dtype=torch.uint8)
    return batch


def random_nms_inputs(dev, gen, b=BATCH, k=1024, classes=80):
    """Clustered boxes in a 640 frame, scores with ties and zeros, classes."""
    centers = (torch.rand((b, k // 8, 1, 2), generator=gen) * SIZE).expand(
        b, k // 8, 8, 2).reshape(b, k, 2)
    centers = centers + torch.randn((b, k, 2), generator=gen) * 6
    wh = 8 + torch.rand((b, k, 2), generator=gen) * 112
    boxes = torch.cat([centers - wh / 2, centers + wh / 2], -1)
    scores = torch.rand((b, k), generator=gen)
    scores[:, 1::5] = scores[:, ::5][:, : scores[:, 1::5].shape[1]]
    scores[:, :64] = 0.0
    cls = torch.randint(0, classes, (b, k), generator=gen)
    return boxes.to(dev), scores.to(dev), cls.to(dev)


def crowd_nms_inputs(dev, gen, b=BATCH, k=1024):
    """One class, boxes crowded around one point: at thr 0.3 fewer than 100
    of 1024 survive, so the kernel scans all 32 tiles of 32 candidates."""
    centers = 200 + torch.rand((b, k, 2), generator=gen) * 240
    wh = 40 + torch.rand((b, k, 2), generator=gen) * 120
    boxes = torch.cat([centers - wh / 2, centers + wh / 2], -1)
    scores = 0.01 + torch.rand((b, k), generator=gen)
    return boxes.to(dev), scores.to(dev)


def grid_mask_inputs(dev, gen, size: int = SIZE):
    """Parameters for TRAIN_BATCH images drawn as the training path draws
    them, every other one made an identity (keep 0 in mode 0 where d > 1),
    and the uint8 and float32 images of [TRAIN_BATCH, size, size, 3]."""
    from yolov7_d2_tpu_torch.data.device_aug import sample_grid_mask_params
    params = sample_grid_mask_params(gen, TRAIN_BATCH, size, size, 0.75)
    params[::2, 4] = torch.where(params[::2, 0] > 1, 0, params[::2, 4])
    shape = (TRAIN_BATCH, size, size, 3)
    u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    f32 = torch.rand(shape, generator=gen) * 255
    return params.to(dev), u8.to(dev), f32.to(dev)


def train_batch(n: int, gen: torch.Generator, size: int = SIZE) -> dict:
    """A packed training batch: uint8 [n, size, size, 3] and 1-100 boxes of
    8 px to half the image an image, in ``max_boxes`` 100 valid-first
    slots."""
    g = 100
    xy = torch.rand((n, g, 2), generator=gen) * (size - 8)
    wh = 8 + torch.rand((n, g, 2), generator=gen) * (size // 2 - 8)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    count = torch.randint(1, g + 1, (n, 1), generator=gen)
    valid = torch.arange(g)[None] < count
    return {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": torch.where(valid[..., None], boxes, 0.0),
        "gt_classes": torch.randint(0, 80, (n, g), generator=gen,
                                    dtype=torch.int32) * valid,
        "gt_valid": valid,
    }


def write_mini_coco(root: str, n: int = CLI_IMAGES, seed: int = SEED,
                    segm: bool = False, keypoints: bool = False):
    """``n`` JPEGs of 640x480 (OpenCV), each with 1-8 flat boxes of the 80
    COCO categories on a noisy background, and their COCO JSON; returns
    (json path, image dir). ``segm``: each box also gets a polygon, the
    box with its lower-right corner cut off (the SparseInst feed).
    ``keypoints``: every box is a person (the one category) with 17
    keypoints inside it, visible, occluded or unlabelled (0, 0, 0) (the
    YOLOX-KPTS feed)."""
    import cv2
    import numpy as np

    from yolov7_d2_tpu_torch.data.coco import COCO_CATEGORY_IDS

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n):
        img = rng.integers(0, 60, (480, 640, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(1, 9))):
            bw, bh = (int(v) for v in rng.integers(24, 320, 2))
            x = int(rng.integers(0, 640 - bw))
            y = int(rng.integers(0, 480 - bh // 2))
            bh = min(bh, 480 - y)
            img[y:y + bh, x:x + bw] = rng.integers(60, 256, 3)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
            if keypoints:
                v = rng.integers(0, 3, 17)
                pts = np.stack([x + rng.uniform(0, bw, 17),
                                y + rng.uniform(0, bh, 17)], -1)
                kp = np.concatenate([np.where(v[:, None] > 0, pts, 0.0),
                                     v[:, None]], -1)
                anns[-1].update(category_id=1, num_keypoints=int(
                    (v > 0).sum()), keypoints=[float(k) for k in
                                               kp.reshape(-1)])
            if segm:
                anns[-1]["segmentation"] = [[
                    x, y, x + bw, y, x + bw, y + 0.6 * bh,
                    x + 0.6 * bw, y + bh, x, y + bh]]
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": i + 1, "file_name": name, "height": 480,
                       "width": 640})
    js = os.path.join(root, "instances.json")
    with open(js, "w") as f:
        cats = [1] if keypoints else COCO_CATEGORY_IDS
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": str(c)} for c in cats]}, f)
    return js, img_dir


def cli_argv(out: str, *flags, config: str = "yolox_s.yaml", **opts) -> list:
    """``train_det``'s command line for ``configs/coco/<config>`` on the
    mini-COCO: 16 images a step, 12 steps, a checkpoint every 6, the COCO
    eval at 12; ``opts`` (keys with ``__`` for ``.``) override."""
    base = {"DATASETS.TRAIN": (CLI_DATASET,), "DATASETS.TEST": (CLI_DATASET,),
            "OUTPUT_DIR": out, "SEED": SEED,
            "SOLVER.IMS_PER_BATCH": TRAIN_BATCH, "SOLVER.MAX_ITER": 12,
            "SOLVER.CHECKPOINT_PERIOD": 6, "TEST.EVAL_PERIOD": 12}
    base.update({k.replace("__", "."): v for k, v in opts.items()})
    argv = ["--config-file", os.path.join(REPO, "configs", "coco", config),
            *flags]
    for k, v in base.items():
        argv += [k, v if isinstance(v, str) else repr(v)]
    return argv


def cli_args(out: str, *flags, **opts):
    """:func:`cli_argv` parsed by the entry points' parser."""
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    return default_argument_parser().parse_args(cli_argv(out, *flags, **opts))


def loader_rate(loader, batches: int = 10, to=None, warm: int = 1) -> float:
    """Images a second of ``loader`` over ``batches`` batches after its
    first ``warm`` (host clock; with ``to``, through a ``CudaPrefetcher``
    onto that device, synchronized at the end)."""
    from yolov7_d2_tpu_torch.data.loader import CudaPrefetcher

    it = iter(loader if to is None else CudaPrefetcher(loader, to))
    for _ in range(warm):
        first = next(it)
    t0 = time.perf_counter()
    n = sum(len(next(it)["image"]) for _ in range(batches))
    if to is not None:
        torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    it.close()
    del first
    return rate


def cli_checks(trainer, out: str, name: str) -> dict:
    """Finite losses, weights and EMA moved since the first checkpoint;
    returns the storage's last scalars."""
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer

    latest = trainer.storage.latest()
    for key in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1",
                "grad_norm"):
        if key not in latest or not math.isfinite(latest[key]):
            raise AssertionError(f"{name}: {key} = {latest.get(key)}")
    ckpt = Checkpointer(os.path.join(out, "ckpt"))
    first = ckpt.load(ckpt.steps()[0], map_location="cpu")
    state = trainer.state
    for kind, now, then in (
            ("parameters", dict(state.model.named_parameters()),
             first["model"]),
            ("EMA", state.ema_params, first["ema_params"])):
        if all(torch.equal(v.detach().cpu(), then[k]) for k, v in now.items()):
            raise AssertionError(f"{name}: no {kind} moved after step "
                                 f"{ckpt.steps()[0]}")
    return latest


@dataclasses.dataclass
class CliData:
    """The CLI phases' synthetic mini-COCO (registered as CLI_DATASET) and
    its packed shards, under ``work``."""

    work: str
    js: str
    img_dir: str
    records: list
    geo: str
    plain: str


def write_cli_data(**opts) -> CliData:
    """Write the mini-COCO of 64 JPEGs and its geometry and plain shards
    (``opts`` override config keys), and register it."""
    from yolov7_d2_tpu_torch.data.catalog import register_coco_instances
    from yolov7_d2_tpu_torch.data.coco import load_coco_json
    from yolov7_d2_tpu_torch.data.packed_cache import (
        write_geometry_shards,
        write_plain_shards,
    )
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    work = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    js, img_dir = write_mini_coco(work)
    register_coco_instances(CLI_DATASET, {}, js, img_dir)
    records = load_coco_json(js, img_dir)
    ccfg = setup_cfg(cli_args(work, **opts))
    geo, plain = os.path.join(work, "geo"), os.path.join(work, "plain")
    write_geometry_shards(records, ccfg, geo)
    write_plain_shards(records, ccfg, plain)
    log(f"cli: mini-COCO of {len(records)} images 640x480 and its packed "
        f"shards (geometry, plain) written in "
        f"{time.perf_counter() - t0:.2f} s")
    return CliData(work, js, img_dir, records, geo, plain)


def cli_phase(dev, card: str, kernels: dict, data: CliData, **opts):
    """``train_det.main`` as a user runs it: ``configs/coco/yolox_s.yaml``
    at 640 px and 80 classes on the synthetic mini-COCO of 64 JPEGs
    (``opts`` override config keys). Run A is the host mosaic feed, with
    the COCO eval at step 12 and then ``--resume`` to 16; run B the packed
    feed with GridMask on and the plain shards from step 8; run C the
    device geometry feed (``INPUT.MOSAIC_AND_MIXUP.DEVICE``: the tile
    loader, ``DeviceAug`` in the step) with GridMask on and the COCO eval
    at step 12. Checks the runs, sets the kernels' ``launches`` to the
    CLI's and returns the median seconds a step of each feed and run C's
    launches (which the caller adds once section 10 (b) has set the
    entries)."""
    import numpy as np

    from yolov7_d2_tpu_torch import native, train_det
    from yolov7_d2_tpu_torch.data import mappers
    from yolov7_d2_tpu_torch.data.loader import build_detection_train_loader
    from yolov7_d2_tpu_torch.data.packed_cache import PackedShardLoader
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    work, records, geo, plain = data.work, data.records, data.geo, data.plain
    ccfg = setup_cfg(cli_args(work, **opts))

    # the loaders alone, 10 batches of 16 after the first
    host_rate = loader_rate(build_detection_train_loader(
        ccfg, records, mappers.YOLOXDatasetMapper(ccfg, seed=0)))
    host_card_rate = loader_rate(build_detection_train_loader(
        ccfg, records, mappers.YOLOXDatasetMapper(ccfg, seed=0)), to=dev)
    packed_rate = loader_rate(PackedShardLoader(
        geo, TRAIN_BATCH, image_dtype=np.uint8, seed=SEED))
    packed_card_rate = loader_rate(PackedShardLoader(
        geo, TRAIN_BATCH, image_dtype=np.uint8, seed=SEED), to=dev)
    tile_rate = loader_rate(build_detection_train_loader(
        ccfg, records, mappers.TileDatasetMapper(ccfg, seed=0)))
    log(f"cli loaders on [{card}], {TRAIN_BATCH} images a batch: host "
        f"mosaic (YOLOXDatasetMapper, {ccfg.DATALOADER.NUM_WORKERS} "
        f"threads) {host_rate:.1f} img/s alone, {host_card_rate:.1f} img/s "
        f"through CudaPrefetcher onto the card; packed shards "
        f"{packed_rate:.1f} img/s alone, {packed_card_rate:.1f} img/s onto "
        f"the card; tiles (TileDatasetMapper, the device feed's) "
        f"{tile_rate:.1f} img/s alone")

    # run A: the host mosaic feed
    out_a = os.path.join(work, "host")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    run_a = train_det.main(cli_args(out_a, **opts))
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = dict(build.LAUNCHES)
    log(f"cli run A (host mosaic) launches: {launches_a}")
    latest_a = cli_checks(run_a, out_a, "cli run A")
    eval_batches = -(-len(records) // TRAIN_BATCH)
    for name in ("normalize", "nms"):
        if launches_a.get(name, 0) != eval_batches:
            raise AssertionError(f"cli run A: {name} launched "
                                 f"{launches_a.get(name, 0)} times for "
                                 f"{eval_batches} eval batches")
    if launches_a.get("grid_mask", 0):
        raise AssertionError("cli run A: GridMask ran on the host feed")
    missing = [k for k in COCO_KEYS if f"eval/{k}" not in latest_a]
    if missing:
        raise AssertionError(f"cli run A: no COCO {missing} in {latest_a}")
    kernels["normalize"]["launches"] = launches_a["normalize"]
    kernels["nms"]["launches"] = launches_a["nms"]
    median_a = run_a.storage.median("time_per_iter")
    letterbox = ("native (build/native)" if mappers._NATIVE else
                 f"cv2: the native build failed: {native.BUILD_ERROR}")
    log(f"cli letterbox: {letterbox} for the eval and plain samples; the "
        f"mosaic samples take cv2's, as the JAX mapper does")
    log("cli run A COCO eval at step 12: " + ", ".join(
        f"{k} {latest_a['eval/' + k]:.4f}" for k in COCO_KEYS))

    eval_fn = train_det.build_eval_fn(ccfg, records)
    build.reset_launches()
    t0 = time.perf_counter()
    eval_fn(run_a)
    eval_s = time.perf_counter() - t0
    if dict(build.LAUNCHES) != {"normalize": eval_batches,
                                "nms": eval_batches}:
        raise AssertionError(f"eval launches {dict(build.LAUNCHES)}")
    ckpt = Checkpointer(os.path.join(work, "ckpt_timed"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(12, run_a.state)
    save_ms = (time.perf_counter() - t0) * 1e3
    save_mb = os.path.getsize(ckpt.path(12)) / 1e6
    del run_a

    run_r = train_det.main(cli_args(out_a, "--resume", SOLVER__MAX_ITER=16,
                                    **opts))
    if run_r.start_iter != 12 or run_r.storage.iter != 16:
        raise AssertionError(f"cli --resume ran {run_r.start_iter} -> "
                             f"{run_r.storage.iter}, not 12 -> 16")
    cli_checks(run_r, out_a, "cli --resume")
    log(f"cli --resume: started at {run_r.start_iter}, ran to "
        f"{run_r.storage.iter}; checkpoints "
        f"{Checkpointer(os.path.join(out_a, 'ckpt')).steps()}")
    del run_r

    # run B: the packed feed, GridMask on, plain shards from step 8
    out_b = os.path.join(work, "packed")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    run_b = train_det.main(cli_args(
        out_b, DATALOADER__PACKED_CACHE_DIR=geo,
        DATALOADER__PACKED_CACHE_PLAIN_DIR=plain,
        INPUT__GRID_MASK__ENABLED=True,
        INPUT__MOSAIC_AND_MIXUP__DISABLE_AT_ITER=8, TEST__EVAL_PERIOD=0,
        **opts))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = dict(build.LAUNCHES)
    log(f"cli run B (packed) launches: {launches_b}")
    cli_checks(run_b, out_b, "cli run B")
    # GridMask once a step before DISABLE_AT_ITER and never after; after
    # it the plain uint8 images go through the normalize kernel
    if launches_b.get("grid_mask", 0) != 8 or \
            launches_b.get("normalize", 0) != 4 or launches_b.get("nms", 0):
        raise AssertionError(f"cli run B launches {launches_b}: GridMask "
                             "must run at steps 0-7 only, normalize at 8-11")
    kernels["grid_mask"]["launches"] = launches_b["grid_mask"]
    median_b = run_b.storage.median("time_per_iter")
    del run_b
    torch.cuda.empty_cache()

    # run C: the device geometry feed, GridMask on, the COCO eval at 12
    out_c = os.path.join(work, "device")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    run_c = train_det.main(cli_args(
        out_c, INPUT__MOSAIC_AND_MIXUP__DEVICE=True,
        INPUT__GRID_MASK__ENABLED=True, **opts))
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches_c = dict(build.LAUNCHES)
    log(f"cli run C (device geometry feed) launches: {launches_c}")
    latest_c = cli_checks(run_c, out_c, "cli run C")
    steps_c = run_c.storage.iter
    if launches_c.get("grid_mask", 0) != steps_c or any(
            launches_c.get(name, 0) != eval_batches
            for name in ("normalize", "nms")):
        raise AssertionError(f"cli run C launches {launches_c}: GridMask "
                             f"once a step, normalize and NMS once an eval "
                             f"batch ({eval_batches})")
    missing = [k for k in COCO_KEYS if f"eval/{k}" not in latest_c]
    if missing:
        raise AssertionError(f"cli run C: no COCO {missing} in {latest_c}")
    median_c = run_c.storage.median("time_per_iter")
    log("cli run C COCO eval at step 12: " + ", ".join(
        f"{k} {latest_c['eval/' + k]:.4f}" for k in COCO_KEYS))
    del run_c
    torch.cuda.empty_cache()

    log(f"cli run A, host mosaic feed, on [{card}]: time_per_iter median "
        f"{median_a * 1e3:.3f} ms = {TRAIN_BATCH / median_a:.1f} img/s; "
        f"12 steps, eval and 2 checkpoints in {wall_a:.2f} s (build "
        f"included)")
    log(f"cli run B, packed feed, on [{card}]: time_per_iter median "
        f"{median_b * 1e3:.3f} ms = {TRAIN_BATCH / median_b:.1f} img/s; "
        f"12 steps and 2 checkpoints in {wall_b:.2f} s (build included)")
    log(f"cli run C, device geometry feed, on [{card}]: time_per_iter "
        f"median {median_c * 1e3:.3f} ms = {TRAIN_BATCH / median_c:.1f} "
        f"img/s (run A {median_a * 1e3:.3f} ms, run B "
        f"{median_b * 1e3:.3f} ms); 12 steps, eval and 2 checkpoints in "
        f"{wall_c:.2f} s (build included)")
    log(f"cli eval on [{card}]: {len(records)} images in {eval_s:.3f} s = "
        f"{len(records) / eval_s:.1f} img/s (mapper, normalize, forward, "
        f"NMS, COCO matching)")
    log(f"cli checkpoint on [{card}]: save {save_ms:.1f} ms, "
        f"{save_mb:.1f} MB (model, optimizer, EMA)")
    return median_a, median_b, median_c, launches_c


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def loss_assignment(outs, key_obj, batch, grids, strides, k) -> dict:
    """What ``yolox_losses`` keeps and matches of head outputs ``outs``
    [B, A, 5 + C] of one batch: its top-``k`` prefilter (None: off), ranked
    by the objectness logits ``key_obj`` [B, A], then SimOTA on the kept
    anchors. Returns ``kept``, ``fg`` (bool) and ``matched_gt`` over all
    A."""
    from yolov7_d2_tpu_torch.models.heads.yolox_head import (
        _geometry_prior,
        _prefilter_key,
        decode_outputs,
        simota_assign,
    )

    gts = [batch[k].to(outs.device)
           for k in ("gt_boxes", "gt_classes", "gt_valid")]
    b, a_total, width = outs.shape
    if k is None or k >= a_total:
        top = torch.arange(a_total, device=outs.device).expand(b, -1)
    else:
        in_box, in_center = _geometry_prior(grids, strides, gts[0])
        cand_any = ((in_box | in_center) & gts[2][..., None]).any(-2)
        top = torch.topk(_prefilter_key(cand_any, key_obj), k,
                         dim=-1).indices.sort(dim=-1).values
    out_k = outs.gather(1, top[..., None].expand(-1, -1, width))
    grids_k, strides_k = grids[top], strides[top]
    got = simota_assign(*decode_outputs(out_k, grids_k, strides_k), grids_k,
                        strides_k, *gts)

    def over_a(v, dtype):
        return torch.zeros((b, a_total), dtype=dtype,
                           device=outs.device).scatter(1, top, v.to(dtype))

    return {"kept": over_a(torch.ones_like(top), torch.bool),
            "fg": over_a(got["fg_mask"], torch.bool),
            "matched_gt": over_a(got["matched_gt"], torch.long)}


def assignment_gaps(outs, other, batch, grids, strides, k) -> tuple:
    """Between the one process's head outputs ``outs`` and the ranks'
    ``other`` [B, A, 5 + C] of one batch: the anchors the loss's top-``k``
    prefilter of each keeps apart (each ranked by its own objectness), and
    the anchors whose SimOTA assignment (foreground, matched box) differs
    among those the ranks keep (both ranked by the ranks' objectness, as
    in :func:`sync_phase`'s one-process step)."""
    ranks = loss_assignment(other, other[..., 4], batch, grids, strides, k)
    own = loss_assignment(outs, outs[..., 4], batch, grids, strides, k)
    one = loss_assignment(outs, other[..., 4], batch, grids, strides, k)
    kept_apart = int((own["kept"] != ranks["kept"]).sum())
    flips = int(((one["fg"] != ranks["fg"])
                 | (one["fg"] & (one["matched_gt"] != ranks["matched_gt"])))
                .sum())
    return kept_apart, flips


@contextlib.contextmanager
def prefilter_ranked_by(obj_logits: torch.Tensor):
    """Within the block, ``yolox_losses``'s top-K prefilter ranks the
    anchors by ``obj_logits`` [B, A] (another run's objectness of the same
    batch) in place of the step's own: both runs' losses then keep the
    same anchors."""
    from yolov7_d2_tpu_torch.models.heads import yolox_head

    own = yolox_head._prefilter_key
    yolox_head._prefilter_key = lambda cand_any, _: own(cand_any, obj_logits)
    try:
        yield
    finally:
        yolox_head._prefilter_key = own


def spawn_plans(plans: list, world: int, backend: str) -> None:
    """The rank calls of every plan (``calls``: ``(fn, (out_dir, ...))``)
    in one spawn of ``world`` ranks, in turn (``dryrun.in_turn``: each
    rank starts once), TF32 off in the ranks as here; sets each plan's
    ``wall`` (the spawn's seconds) and ``shared`` (how many plans it
    ran)."""
    from yolov7_d2_tpu_torch.parallel.dryrun import in_turn
    from yolov7_d2_tpu_torch.parallel.launch import launch

    for plan in plans:
        shutil.rmtree(plan.out, ignore_errors=True)
        for _, args in plan.calls:
            os.makedirs(args[0], exist_ok=True)
    # the ranks start with torch's defaults: TF32 off for them as here
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    t0 = time.perf_counter()
    try:
        launch(in_turn, world, args=([c for plan in plans
                                      for c in plan.calls],),
               backend=backend)
    finally:
        del os.environ["NVIDIA_TF32_OVERRIDE"]
    for plan in plans:
        plan.wall, plan.shared = time.perf_counter() - t0, len(plans)


def spawned(plan) -> str:
    return (f"{plan.wall:.2f} s for the spawn, the ranks' start-up and "
            + ("its steps" if plan.shared == 1 else
               f"the steps of {plan.shared} checks in turn"))


def sync_plan(dev, cfg, world: int = 2, backend: str = "gloo",
              follow_ranks: bool = True):
    """The ranks' part of :func:`sync_phase`: its batches and rank call."""
    from yolov7_d2_tpu_torch.parallel.dryrun import train_steps

    fcfg = dataclasses.replace(cfg, amp=False)
    gen = torch.Generator().manual_seed(SEED + 2)
    batches = [train_batch(2 * world, gen) for _ in range(2)]
    out = os.path.join(REPO, "build", "chip_smoke_ranks")
    # gloo: every rank on ``dev``; NCCL: rank i on card i
    calls = [(train_steps, (
        out, fcfg, batches, str(dev) if backend == "gloo" else dev.type,
        SEED, None, 1 if dev.type == "cuda" else None, True, follow_ranks))]
    return types.SimpleNamespace(out=out, calls=calls, fcfg=fcfg,
                                 batches=batches, world=world,
                                 backend=backend, follow_ranks=follow_ranks)


def sync_phase(dev, card: str, cfg, world: int = 2,
               backend: str = "gloo", follow_ranks: bool = True,
               plan=None):
    """(a) ``world`` ranks on one card over gloo (``launch(...,
    backend="gloo")``), or (c) one card each over NCCL: the bare YOLOX-s
    640 train step in float32, TF32 off, 2 images a rank, 2 steps
    (``parallel.dryrun.train_steps``: ``SyncBatchNorm2d``, the global
    foreground count, DDP), against the one-process step on the same
    images, each step taken from the ranks' weights before it
    (``follow_ranks``; else one process follows its own updates): the fg
    count equal, the summed loss shares and the gradient norm within 1e-3
    relative (the card-vs-CPU bound of section 9), and parameters, EMA and
    BN buffers bitwise equal across the ranks. From the ranks' weights,
    because two runs that update apart drift on the card by more than one
    step differs: one process against itself moves its head outputs by
    3.1e-4 of their max by step 2 (``tools/sync_step_gap.py``). The one
    process's loss keeps the anchors the ranks' top-K prefilter kept
    (:func:`prefilter_ranked_by`): these images hold 4000-8000 SimOTA
    candidates of 8400 anchors, the prefilter keeps 2100 by objectness,
    and head outputs 3e-5 apart reorder anchors at that boundary, which
    moves a loss by a jump and not by rounding. Logs how far the head
    outputs differ, in how many anchors the prefilter of each run's own
    outputs keeps apart, and in how many anchors the SimOTA assignment of
    each run's outputs differs among those kept (:func:`assignment_gaps`);
    with ``follow_ranks`` also the gaps of the one-process step under its
    own prefilter (taken first from the same weights, not held).
    Both count the CUDA kernels the host launches in step 1. The ranks'
    part comes from ``plan`` (:func:`sync_plan`, run by the caller's
    spawn), or is spawned here. Returns the batches, the one process's head
    outputs and the ranks' outputs, step by step."""
    from yolov7_d2_tpu_torch.engine import (
        build_yolox_system,
        resolve_simota_prefilter,
    )
    from yolov7_d2_tpu_torch.utils.profiling import count_cuda_launches

    label = "(a)" if backend == "gloo" else "(c)"
    if plan is None:
        plan = sync_plan(dev, cfg, world, backend, follow_ranks)
        spawn_plans([plan], world, backend)
    fcfg, batches, out = plan.fcfg, plan.batches, plan.out
    world, follow_ranks = plan.world, plan.follow_ranks
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)

    k = resolve_simota_prefilter(fcfg)
    _, state, step = build_yolox_system(fcfg, device=dev, seed=SEED)
    heads = []
    state.model.register_forward_hook(
        lambda module, args, head: heads.append(
            {k: v.detach().float() for k, v in head.items()}))
    one, own = [], []
    for i, batch in enumerate(batches):
        batch = {k: v.to(dev) for k, v in batch.items()}
        if follow_ranks:
            # first the step under its own prefilter, for the log only
            state.model.load_state_dict(ranks[0]["weights"][i])
            state.step = i
            state, m = step(state, batch)
            own.append({k: float(v) for k, v in m.items()})
            heads.pop()
            state.model.load_state_dict(ranks[0]["weights"][i])
            state.step = i
        ranked = torch.cat([rec["outputs"][i][..., 4] for rec in ranks])
        with prefilter_ranked_by(ranked.to(dev)):
            if i == 1:
                (state, m), launches_one = count_cuda_launches(
                    lambda: step(state, batch))
            else:
                state, m = step(state, batch)
        one.append({k: float(v) for k, v in m.items()})
    for i, want in enumerate(one):
        ms = [rec["metrics"][i] for rec in ranks]
        loss = sum(m["total_loss"] for m in ms)
        outs = heads[i]["outputs"]
        other = torch.cat([rec["outputs"][i] for rec in ranks]).to(dev)
        out_gap = float((other - outs).abs().max() / outs.abs().max())
        kept_apart, flips = assignment_gaps(
            outs, other, batches[i], heads[i]["grids"], heads[i]["strides"],
            k)
        gaps = {k: relative_gap(got, want[k]) for k, got in (
            ("total_loss", loss), ("grad_norm", ms[0]["grad_norm"]))}
        log(f"{label} step {i}: {world} ranks / one process: total_loss "
            f"{loss:.6g} / {want['total_loss']:.6g} ({gaps['total_loss']:.2e}"
            f"), grad_norm {ms[0]['grad_norm']:.6g} / "
            f"{want['grad_norm']:.6g} ({gaps['grad_norm']:.2e}), num_fg "
            f"{ms[0]['num_fg']:.0f} / {want['num_fg']:.0f}; head outputs "
            f"differ by {out_gap:.2e} of their max; the top-{k} prefilter "
            f"of each keeps {kept_apart} anchors apart (the one process "
            f"takes the ranks'), SimOTA assignments differ in {flips}"
            + ("" if not own else "; under its own prefilter the one "
               f"process is {relative_gap(loss, own[i]['total_loss']):.2e}"
               " in total_loss and "
               f"{relative_gap(ms[0]['grad_norm'], own[i]['grad_norm']):.2e}"
               " in grad_norm apart (not held)"))
        if any(m["num_fg"] != want["num_fg"] for m in ms):
            raise AssertionError(f"{label} step {i}: fg counts differ")
        if len({m["grad_norm"] for m in ms}) != 1:
            raise AssertionError(f"{label} step {i}: the ranks' gradient "
                                 "norms differ")
        for key, gap in gaps.items():
            if gap > 1e-3:
                raise AssertionError(f"{label} step {i}: {key} off by "
                                     f"{gap:.2e} relative to one process, "
                                     "above 1e-3")
    for rec in ranks[1:]:
        for key in ("model", "ema"):
            for name, v in ranks[0][key].items():
                if not torch.equal(v, rec[key][name]):
                    raise AssertionError(f"{label} ranks differ in {key} "
                                         f"{name}")
    if any(rec["step"] != 2 for rec in ranks):
        raise AssertionError(f"{label} the ranks took other than 2 steps")
    launches_rank = ranks[0]["metrics"][1].get("launches")
    where = ("on one card, host-paced over gloo and not a multi-GPU rate"
             if backend == "gloo" else "over NCCL, one card each")
    log(f"{label} {world} {backend} ranks [{card}]: parameters, BN buffers "
        f"and EMA bitwise equal across the ranks after 2 steps; CUDA kernel "
        f"launches in step 1: one process {launches_one} ({2 * world} "
        f"images), a rank {launches_rank} (2 images, SyncBatchNorm2d + DDP); "
        f"{spawned(plan)}, {where}")
    return batches, heads, [rec["outputs"] for rec in ranks]


def backward_trace(state, train_step, batch) -> dict:
    """One train step of ``state`` on ``batch`` with every module output's
    gradient and every parameter's recorded in the order the backward
    computes them (tensor hooks: a tensor's gradient is whole once every
    consumer's backward has run): ``{"outputs": [(module name, grad)],
    "params": [(name, grad)], "metrics": {...}, "weights": {name: value}}``,
    the gradients cloned on the card."""
    model = state.model
    outputs, params, handles = [], [], []

    def on_output(name):
        def hook(module, args, out):
            tensors = (out.values() if isinstance(out, dict) else
                       out if isinstance(out, (tuple, list)) else (out,))
            for j, t in enumerate(tensors):
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    t.register_hook(lambda g, key=f"{name}[{j}]":
                                    outputs.append((key, g.detach().clone())))
        return hook

    for name, module in model.named_modules():
        handles.append(module.register_forward_hook(
            on_output(name or "model")))
    for name, p in model.named_parameters():
        handles.append(p.register_post_accumulate_grad_hook(
            lambda p, name=name: params.append((name, p.grad.detach()
                                                .clone()))))
    try:
        _, metrics = train_step(state, batch)
    finally:
        for h in handles:
            h.remove()
    return {"outputs": outputs, "params": params,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "weights": {k: v.detach().clone()
                        for k, v in model.state_dict().items()}}


def trace_gaps(a: dict, b: dict) -> dict:
    """Where two :func:`backward_trace` runs of the same step part: the
    first module-output gradient (in the backward's order) that is not
    bitwise equal, the module whose gradient the backward computed just
    before it, the first parameter gradient that differs, their largest
    differences over their largest magnitude, and how many of each
    differ."""
    def first(xs, ys):
        names = [n for n, _ in xs]
        if names != [n for n, _ in ys]:
            raise AssertionError("the two runs' backwards took other orders")
        bad = [i for i, ((_, x), (_, y)) in enumerate(zip(xs, ys))
               if not torch.equal(x, y)]
        if not bad:
            return None, None, 0.0, 0
        i = bad[0]
        x, y = xs[i][1].float(), ys[i][1].float()
        rel = float((x - y).abs().max() / x.abs().max().clamp(min=1e-30))
        return names[i], (names[i - 1] if i else None), rel, len(bad)

    out_name, out_prev, out_rel, out_n = first(a["outputs"], b["outputs"])
    par_name, _, par_rel, par_n = first(a["params"], b["params"])
    weights_equal = all(torch.equal(v, b["weights"][k])
                        for k, v in a["weights"].items())
    return {"output": out_name, "before": out_prev, "output_gap": out_rel,
            "outputs_differ": out_n, "outputs": len(a["outputs"]),
            "param": par_name, "param_gap": par_rel, "params_differ": par_n,
            "params": len(a["params"]), "weights_equal": weights_equal,
            "metrics_equal": a["metrics"] == b["metrics"]}


def repeat_phase(dev, card: str, what: str, build_fn, batch) -> dict:
    """C.14: the same train step twice, each from a fresh
    ``build_fn() -> (state, train_step)`` (the same seeded weights) on the
    same ``batch``; logs and returns :func:`trace_gaps`: whether the
    gradients and the weights after the step are bitwise equal, else the
    first gradient that differs."""
    runs = []
    for _ in range(2):
        state, train_step = build_fn()
        runs.append(backward_trace(state, train_step, batch))
        del state, train_step
    gaps = trace_gaps(*runs)
    del runs
    torch.cuda.empty_cache()
    if gaps["outputs_differ"] == 0 and gaps["params_differ"] == 0:
        log(f"C.14 {what} on [{card}]: two runs of the step from the same "
            f"weights and batch: all {gaps['outputs']} module-output and "
            f"{gaps['params']} parameter gradients bitwise equal; weights "
            f"after the step equal: {gaps['weights_equal']}")
    else:
        log(f"C.14 {what} on [{card}]: two runs of the step part at the "
            f"gradient of {gaps['output']} ({gaps['output_gap']:.2e} of its "
            f"max; the backward computed {gaps['before']} just before it, "
            f"bitwise equal), {gaps['outputs_differ']} of "
            f"{gaps['outputs']} module-output gradients differ; the first "
            f"parameter gradient to differ is {gaps['param']} "
            f"({gaps['param_gap']:.2e}), {gaps['params_differ']} of "
            f"{gaps['params']}; metrics equal: {gaps['metrics_equal']}, "
            f"weights equal: {gaps['weights_equal']}")
    return gaps


def sync_bn_plan(dev, world: int = 2, backend: str = "gloo"):
    """The ranks' part of :func:`sync_bn_phase`: its inputs (both dtypes)
    and rank calls."""
    from yolov7_d2_tpu_torch.parallel.dryrun import norm_sync_ranks

    n, c, hw = 2 * world, 128, 80
    gen = torch.Generator().manual_seed(SEED + 4)
    params = {"weight": torch.rand(c, generator=gen) + 0.5,
              "bias": torch.randn(c, generator=gen), "eps": 1e-3,
              "momentum": 0.03}
    running = torch.stack([torch.stack([torch.randn(c, generator=gen),
                                        torch.rand(c, generator=gen) + 0.5])
                           for _ in range(world)])
    out = os.path.join(REPO, "build", "chip_smoke_bn")

    def nhwc(t, dtype):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    cases = []
    for dtype, close, stat_close in ((torch.float32, 1e-4, 1e-4),
                                     (torch.bfloat16, 1e-2, 1e-4)):
        x = nhwc(torch.randn((n, c, hw, hw), generator=gen) * 3.0 + 1.0,
                 dtype)
        grad_out = nhwc(torch.randn((n, c, hw, hw), generator=gen), dtype)
        batches = torch.stack([
            nhwc(torch.randn((n, c, hw, hw), generator=gen) * 2.0 - 1.0,
                 dtype) for _ in range(2)])
        cases.append((dtype, close, stat_close, x, grad_out, batches,
                      os.path.join(out, str(dtype).split(".")[-1])))
    calls = [(norm_sync_ranks, (sub, params, x, grad_out, running, batches,
                                str(dev) if backend == "gloo" else dev.type))
             for _, _, _, x, grad_out, batches, sub in cases]
    return types.SimpleNamespace(out=out, calls=calls, world=world, n=n, c=c,
                                 hw=hw, params=params, running=running,
                                 cases=cases)


def sync_bn_phase(dev, card: str, world: int = 2,
                  backend: str = "gloo", plan=None) -> None:
    """``SyncBatchNorm2d`` alone on CUDA tensors (its fused path), ``world``
    ranks on one card over gloo or one card each over NCCL
    (``parallel.dryrun.norm_sync_ranks``), at a YOLOX-s 640 layer's shape
    (2 images a rank, 128 channels at 80 x 80, channels_last), in float32
    and in bfloat16 (the recipe's activations, float32 weights), against
    ``nn.BatchNorm2d`` (cuDNN) on the whole batch on this card (the ranks'
    part from ``plan``, :func:`sync_bn_plan`, run by the caller's spawn, or
    spawned here): output, input gradient, the summed weight and bias
    gradients, the running statistics, and ``all_reduce_norm`` and ``precise_bn`` against their
    one-process values; every rank's statistics bitwise equal. Bounds, of
    the reference's largest magnitude: float32 1e-4 (the same moments in
    another sum order); bfloat16 1e-2 for the outputs and gradients (both
    round to bfloat16, whose step is 2^-8 of a value) and 1e-4 for the
    statistics (float32 moments of the same bfloat16 inputs)."""
    from yolov7_d2_tpu_torch.parallel.norm_sync import (
        SyncBatchNorm2d,
        precise_bn,
    )

    label = "(a)" if backend == "gloo" else "(c)"
    if plan is None:
        plan = sync_bn_plan(dev, world, backend)
        spawn_plans([plan], world, backend)
    world, n, c, params, running, cases = (
        plan.world, plan.n, plan.c, plan.params, plan.running, plan.cases)
    hw = plan.hw
    for dtype, close, stat_close, x, grad_out, batches, sub in cases:
        ranks = [torch.load(os.path.join(sub, f"rank{r}.pt"),
                            weights_only=True) for r in range(world)]
        for key in ("running_mean", "running_var", "reduced_mean",
                    "reduced_var", "precise_mean", "precise_var"):
            if any(not torch.equal(r[key], ranks[0][key]) for r in ranks):
                raise AssertionError(f"{label} SyncBatchNorm2d {dtype}: the "
                                     f"ranks' {key} differ")
        ref = torch.nn.BatchNorm2d(c, eps=1e-3, momentum=0.03).to(dev)
        with torch.no_grad():
            ref.weight.copy_(params["weight"])
            ref.bias.copy_(params["bias"])
        xr = x.to(dev).requires_grad_(True)
        y = ref(xr)
        y.backward(grad_out.to(dev))
        one = SyncBatchNorm2d(c, eps=1e-3, momentum=0.03).to(dev)
        precise_bn(one, [b.to(dev) for b in batches])
        want = {
            "y": (torch.cat([r["y"] for r in ranks]), y, close),
            "x_grad": (torch.cat([r["x_grad"] for r in ranks]), xr.grad,
                       close),
            "weight_grad": (sum(r["weight_grad"] for r in ranks),
                            ref.weight.grad, close),
            "bias_grad": (sum(r["bias_grad"] for r in ranks), ref.bias.grad,
                          close),
            "running_mean": (ranks[0]["running_mean"], ref.running_mean,
                             stat_close),
            "running_var": (ranks[0]["running_var"], ref.running_var,
                            stat_close),
            "reduced_mean": (ranks[0]["reduced_mean"], running[:, 0].mean(0),
                             1e-6),
            "reduced_var": (ranks[0]["reduced_var"], running[:, 1].mean(0),
                            1e-6),
            "precise_mean": (ranks[0]["precise_mean"], one.running_mean,
                             stat_close),
            "precise_var": (ranks[0]["precise_var"], one.running_var,
                            stat_close),
        }
        errs = {}
        for key, (got, ref_t, tol) in want.items():
            ref_t = ref_t.detach().float().cpu()
            errs[key] = float((got.float().cpu() - ref_t).abs().max()
                              / ref_t.abs().max())
            if not errs[key] <= tol:
                raise AssertionError(f"{label} SyncBatchNorm2d {dtype}: {key} "
                                     f"off by {errs[key]:.2e} of its max, "
                                     f"above {tol}")
        log(f"{label} SyncBatchNorm2d {str(dtype).split('.')[-1]} on "
            f"{world} {backend} ranks [{card}] vs nn.BatchNorm2d on "
            f"[{n},{c},{hw},{hw}]: " + ", ".join(
                f"{k} {e:.2e}" for k, e in errs.items())
            + " (of the max); the ranks' statistics bitwise equal")
    shutil.rmtree(plan.out, ignore_errors=True)


def packed_step_ms(dev, cfg, batches, in_group: bool) -> float:
    """Milliseconds a step of section 8's on-card packed step (16 images,
    GridMask on), 10 steps after 3, built inside an NCCL group of 1 (DDP)
    or without a group."""
    import torch.distributed as dist

    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.parallel.dist import init_distributed
    from yolov7_d2_tpu_torch.parallel.launch import local_dist_url

    if in_group:
        init_distributed("nccl", local_dist_url(), 1, 0)
    try:
        _, state, train_step = build_yolox_system(cfg, device=dev, seed=SEED)
        if (state.ddp is not None) != in_group:
            raise AssertionError("DDP built where it should not, or not "
                                 "where it should")
        step = make_packed_photo_step(cfg, train_step, seed=SEED)
        for i in range(WARMUP):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / ITERS
    finally:
        if in_group:
            dist.destroy_process_group()


def ddp_world1_phase(dev, card: str, kernels: dict, data: CliData,
                     cfg=None, **opts) -> None:
    """(b) The CLI's packed feed (``train_det.main``, 6 steps of 16 images,
    GridMask until ``DISABLE_AT_ITER`` 4, plain shards after, the COCO eval
    at 6 on rank 0) inside an NCCL group of 1: ``SyncBatchNorm2d`` (plain at
    a world of 1) and DDP. Its losses at step 6 against the run of the same
    steps without a group within 1e-3 relative; the medians of both runs'
    ``time_per_iter`` logged. Six CLI steps hold a first step, a shard
    load and a checkpoint, so DDP's cost on one card is timed apart, where
    ``cfg`` is given: section 8's on-card step, in turns without a group,
    in the group, in the group, without. Sets the kernels' ``launches`` to
    the CLI run's."""
    import torch.distributed as dist

    from yolov7_d2_tpu_torch import train_det
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.parallel.dist import init_distributed
    from yolov7_d2_tpu_torch.parallel.launch import local_dist_url

    steps, disable_at = 6, 4
    packed = dict(DATALOADER__PACKED_CACHE_DIR=data.geo,
                  DATALOADER__PACKED_CACHE_PLAIN_DIR=data.plain,
                  INPUT__GRID_MASK__ENABLED=True,
                  INPUT__MOSAIC_AND_MIXUP__DISABLE_AT_ITER=disable_at,
                  SOLVER__MAX_ITER=steps, SOLVER__CHECKPOINT_PERIOD=3,
                  **opts)
    init_distributed("nccl", local_dist_url(), 1, 0)
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run_d = train_det.main(cli_args(
            os.path.join(data.work, "ddp1"), TEST__EVAL_PERIOD=steps,
            **packed))
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        dist.destroy_process_group()
    log(f"(b) NCCL world 1 launches: {launches}")
    if run_d.state.ddp is None:
        raise AssertionError("(b) the run inside a group built no DDP")
    eval_batches = -(-len(data.records) // TRAIN_BATCH)
    want = {"grid_mask": disable_at, "nms": eval_batches,
            "normalize": steps - disable_at + eval_batches}
    if launches != want:
        raise AssertionError(f"(b) launches {launches}, not {want}: GridMask "
                             "at every step before DISABLE_AT_ITER, normalize"
                             " on the plain steps and in the eval, NMS in "
                             "the eval")
    for name, n in want.items():
        kernels[name]["launches"] = n
    latest_d = cli_checks(run_d, os.path.join(data.work, "ddp1"), "(b)")
    missing = [k for k in COCO_KEYS if f"eval/{k}" not in latest_d]
    if missing:
        raise AssertionError(f"(b) rank 0's eval gave no COCO {missing}")
    median_d = run_d.storage.median("time_per_iter")
    del run_d

    t0 = time.perf_counter()
    run_p = train_det.main(cli_args(os.path.join(data.work, "plain1"),
                                    TEST__EVAL_PERIOD=0, **packed))
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    if run_p.state.ddp is not None:
        raise AssertionError("(b) one process without a group built DDP")
    latest_p = cli_checks(run_p, os.path.join(data.work, "plain1"),
                          "(b) no group")
    median_p = run_p.storage.median("time_per_iter")
    del run_p
    torch.cuda.empty_cache()
    keys = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1",
            "num_fg", "grad_norm")
    log(f"(b) step {steps}, NCCL world 1 / no group: " + ", ".join(
        f"{k} {latest_d[k]:.6g} / {latest_p[k]:.6g}" for k in keys))
    for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_l1"):
        if relative_gap(latest_d[k], latest_p[k]) > 1e-3:
            raise AssertionError(f"(b) {k} differs from the run without a "
                                 "group")
    log(f"(b) packed CLI feed on [{card}], {TRAIN_BATCH} images a step: "
        f"time_per_iter median {median_d * 1e3:.3f} ms in an NCCL group of 1 "
        f"(DDP) against {median_p * 1e3:.3f} ms without a group: ratio "
        f"{median_d / median_p:.4f}; {steps} steps in {wall_d:.2f} s (eval "
        f"included) and {wall_p:.2f} s")
    if cfg is None:
        return
    tcfg = dataclasses.replace(cfg, grid_mask=True)
    gen = torch.Generator().manual_seed(SEED + 3)
    batches = [{k: v.to(dev) for k, v in train_batch(TRAIN_BATCH,
                                                     gen).items()}
               for _ in range(4)]
    turns = [(g, packed_step_ms(dev, tcfg, batches, g))
             for g in (False, True, True, False)]
    plain = [ms for g, ms in turns if not g]
    ddp = [ms for g, ms in turns if g]
    log(f"(b) on-card packed step, {TRAIN_BATCH} images, on [{card}], in "
        f"turns (no group, NCCL group of 1, group, no group): "
        + ", ".join(f"{ms:.3f}" for _, ms in turns) + " ms a step; DDP at "
        f"world 1 / no group: {sum(ddp) / sum(plain):.4f}")


def nccl_ranks_phase(dev, card: str, cfg, data: CliData, **opts) -> None:
    """(c) Where two or more cards are visible, N of them (up to 4) over
    NCCL, one a rank: ``dryrun_multigpu(N)`` (the tiny system, one step,
    ranks equal), :func:`sync_phase`'s bare step against one process,
    :func:`sync_bn_phase`, then ``train_custom_datasets --num-gpus N`` on
    the packed feed, 16 images a rank, 6 steps, the COCO eval at 6 on rank
    0; rank 0's metrics.json and checkpoint checked. Logged as skipped on
    one card."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        log(f"(c) NCCL ranks: skipped, {n} CUDA card visible (needs 2)")
        return
    from yolov7_d2_tpu_torch import train_custom_datasets
    from yolov7_d2_tpu_torch.parallel.dryrun import dryrun_multigpu
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer

    t0 = time.perf_counter()
    ranks = dryrun_multigpu(n)
    log(f"(c) dryrun_multigpu({n}) over NCCL [{card}] x{n}: total_loss "
        f"{sum(r['metrics'][0]['total_loss'] for r in ranks):.6g}, ranks "
        f"equal, {time.perf_counter() - t0:.2f} s with start-up")
    sync_phase(dev, card, cfg, world=n, backend="nccl")
    sync_bn_phase(dev, card, world=n, backend="nccl")
    out = os.path.join(data.work, "nccl")
    t0 = time.perf_counter()
    train_custom_datasets.main([
        "--register", CLI_DATASET, data.js, data.img_dir, "--num-gpus",
        str(n), *cli_argv(out, DATALOADER__PACKED_CACHE_DIR=data.geo,
                          INPUT__GRID_MASK__ENABLED=True,
                          SOLVER__IMS_PER_BATCH=n * TRAIN_BATCH,
                          SOLVER__MAX_ITER=6, SOLVER__CHECKPOINT_PERIOD=6,
                          TEST__EVAL_PERIOD=6, **opts)])
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(line) for line in f]
    last = lines[-1]
    if [r["iteration"] for r in lines] != [6] or not math.isfinite(
            last["total_loss"]) or "eval/AP" not in last:
        raise AssertionError(f"(c) rank 0's metrics.json: {lines}")
    if Checkpointer(os.path.join(out, "ckpt")).steps() != [6]:
        raise AssertionError("(c) no checkpoint at step 6")
    log(f"(c) {n} NCCL ranks on [{card}] x{n}: the CLI's packed feed, 6 "
        f"steps of {TRAIN_BATCH} images a rank, eval included, in "
        f"{wall:.2f} s (start-up included); step 6: total_loss "
        f"{last['total_loss']:.6g}, num_fg {last['num_fg']:.0f}, "
        f"time_per_iter {last['time_per_iter'] * 1e3:.3f} ms on rank 0")


def coco_cfg(yaml: str, **replace):
    """The config dataclass of ``configs/coco/<yaml>``'s architecture
    (``engine.config_from_yaml``: merged into the port's ``get_cfg``, as a
    user's config is), with dataclass fields replaced."""
    from yolov7_d2_tpu_torch.engine import config_from_yaml

    return config_from_yaml(os.path.join(REPO, "configs", "coco", yaml),
                            **replace)


def anchor_tail(head, cfg, nms=None):
    """``anchor_yolo_postprocess`` of ``cfg``'s architecture on head
    outputs (the v5 gate for YOLOV5), with the NMS kernel unless ``nms`` is
    given."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolov7 import (
        anchor_yolo_postprocess,
    )

    variant = {"YOLO": cfg.variant, "YOLOV5": "yolov5"}.get(
        cfg.meta_architecture, "yolov7")
    with torch.inference_mode():
        return anchor_yolo_postprocess(
            head, variant, cfg.conf_threshold, cfg.nms_threshold,
            cfg.max_detections, cfg.pre_nms_topk,
            **({} if nms is None else {"nms": nms}))


def anchor_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> head outputs
    -> :func:`anchor_tail` -> ``Detections``."""
    with torch.inference_mode():
        head = model(images)
    return head, anchor_tail(head, cfg)


def check_detections(dets, n: int, cfg, what: str) -> str:
    if dets.boxes.shape != (n, cfg.max_detections, 4) or \
            dets.valid.shape != (n, cfg.max_detections):
        raise AssertionError(f"{what}: Detections shapes "
                             f"{tuple(dets.boxes.shape)}")
    counts = dets.num_valid()
    if int(counts.min()) < 1:
        raise AssertionError(f"{what}: an image with no detection")
    if not torch.isfinite(dets.boxes[dets.valid]).all() or \
            not torch.isfinite(dets.scores).all():
        raise AssertionError(f"{what}: non-finite detections")
    return f"detections per image {int(counts.min())}-{int(counts.max())}"


def check_train_metrics(metrics, what: str) -> None:
    for i, m in enumerate(metrics):
        for key in ("loss_box", "loss_obj", "loss_cls", "total_loss",
                    "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"{what} step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"{what} step {i}: no foreground anchor")


ANCHOR_OTHERS = (("YOLO", "darknet53.yaml", {}),
                 ("YOLOV7P", "yolov7.yaml", {"meta_architecture": "YOLOV7P"}),
                 ("YOLOV7P r50.yaml", "r50.yaml", {}))
RES2NET_OTHERS = (("YOLOV7 r2next_50.yaml", "r2next_50.yaml", {}),
                  ("YOLOV7 r2_50_l.yaml", "r2_50_l.yaml", {}),
                  ("YOLOV7 tl/res2net_bifpn.yaml", "../tl/res2net_bifpn.yaml",
                   {}))


def photo_step(cfg, where, batch, draws, dtype=torch.float32):
    """One train step of ``build_system(cfg)`` on ``where`` (weights of
    ``SEED``, TF32 off on the card) on ``batch`` after
    ``DevicePhotometric``'s ``draws``, its model in ``dtype``: (metrics as
    floats, each parameter's gradient in float64 on the CPU). The
    gradients are read just before the optimizer's update: on CUDA
    tensors torch's SGD takes its foreach path, whose Nesterov momentum
    adds into the gradients of the groups without weight decay in place
    (x1.9 at the first step), where its CPU path leaves them."""
    import warnings

    from yolov7_d2_tpu_torch.data.device_aug import DevicePhotometric
    from yolov7_d2_tpu_torch.engine import build_system

    if dtype != torch.float32:
        cfg = dataclasses.replace(cfg, ema=False)
    _, state, step, _ = build_system(cfg, device=where, seed=SEED)
    if dtype != torch.float32:
        state.model.to(dtype)
        state.model.dtype = dtype
    grads = {}
    state.optimizer.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().double().cpu()
         for n, p in state.model.named_parameters() if p.grad is not None}))
    b = DevicePhotometric(cfg).apply(
        {k: v.to(where) for k, v in batch.items()}, draws)
    with warnings.catch_warnings():
        # autocast has no float64 form and stands aside, with a warning
        warnings.simplefilter("ignore")
        _, m = step(state, b)
    return {k: float(v) for k, v in m.items()}, grads


def gradient_gaps(got: dict, want: dict) -> tuple:
    """(the whole gradient's distance from ``want``'s over its norm, the
    parameter farthest from ``want``'s relative to its own norm, that
    relative distance)."""
    if got.keys() != want.keys():
        raise AssertionError("the two steps give gradients to other "
                             f"parameters: {sorted(got.keys() ^ want.keys())}")
    whole = math.sqrt(sum(float((got[n] - want[n]).pow(2).sum())
                          for n in want))
    norm = math.sqrt(sum(float(want[n].pow(2).sum()) for n in want))
    rel, worst = max((float((got[n] - want[n]).norm())
                      / max(float(want[n].norm()), 1e-30), n) for n in want)
    return whole / norm, worst, rel


def float64_step_check(dev, card: str, what: str, cfg, batch, draws,
                       card_g: dict, cpu_g: dict, fmt) -> None:
    """Section 18 (b): Res2Net's float32 step is ill-conditioned at 128
    px (its train-mode BatchNorms, about 80 deep, amplify float32 rounding:
    the CPU's own float32 gradient is some 5% from its float64 one in the
    stem's convolutions, which hold most of the gradient norm), so no
    float32 card-vs-CPU bound on the gradient can tell a fault from
    rounding. The same step in float64 on the card (cuDNN's float64
    convolutions) and on the CPU holds the backward of every module
    instead: the loss terms and the gradient norm within 1e-6 relative,
    every parameter's gradient within 1e-5 of its norm. Two float64 CPU
    runs at other thread counts agree to 1.4e-9 a parameter, and 1e-7
    noise on the head's output gradient (the loss stays float32) moves a
    parameter's by at most 3.7e-7. Logs the float32 gradients' distances
    from the float64 CPU one and the parameter that parts the float32
    card and CPU most."""
    ref_m, ref_g = photo_step(cfg, "cpu", batch, draws, torch.float64)
    got_m, got_g = photo_step(cfg, dev, batch, draws, torch.float64)
    log(f"{what} float64 train step, card vs CPU: " + ", ".join(
        f"{k} {got_m[k]:.10g} / {ref_m[k]:.10g}" for k in fmt))
    card32, _, _ = gradient_gaps(card_g, ref_g)
    cpu32, _, _ = gradient_gaps(cpu_g, ref_g)
    _, worst32, rel32 = gradient_gaps(card_g, cpu_g)
    whole, worst, rel = gradient_gaps(got_g, ref_g)
    log(f"{what} gradient against the float64 CPU step on [{card}]: "
        f"float32 card {card32:.3e}, float32 CPU {cpu32:.3e} of its norm; "
        f"float32 card vs CPU farthest at {worst32} ({rel32:.3e} of its "
        f"norm); float64 card {whole:.3e} of the norm, farthest at {worst} "
        f"({rel:.3e} of its norm)")
    if got_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError(f"{what} float64: fg count differs")
    for k in ("total_loss", "loss_box", "loss_obj", "loss_cls",
              "grad_norm"):
        if abs(got_m[k] - ref_m[k]) > 1e-6 * abs(ref_m[k]):
            raise AssertionError(f"{what} float64: {k} differs between the "
                                 "card and the CPU")
    if rel > 1e-5:
        raise AssertionError(f"{what} float64: the gradient of {worst} is "
                             f"{rel:.3e} of its norm from the CPU's")


def anchor_yolo_phase(dev, card: str, gen: torch.Generator,
                      requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                      size: int = SIZE, small: int = 128,
                      yaml: str = "yolov7.yaml", label: str = "11",
                      others=ANCHOR_OTHERS, f32_px=None, kernels=None,
                      f64_step: bool = False) -> None:
    """Section 11: the anchor-YOLO family (``YOLOV7`` at 640 from
    ``configs/coco/yolov7.yaml``, full depth and width, bf16 compute over
    f32 weights from ``SEED``). (a) serving through ``build_model`` +
    ``anchor_yolo_postprocess`` (normalize and NMS kernels) at each request
    size, the kernel path against the plain one, the f32 card against the
    CPU at bs 1 (at ``f32_px`` where given); (b) ``build_system``'s step in
    ``make_packed_photo_step`` with GridMask (mode 1, prob 0.3) and mixup
    on, ``train_n`` images a step for 6 steps, then one f32 step on the
    card against the CPU; (c) one request and one train step each of
    ``others`` (name, yaml under ``configs/coco``, fields replaced):
    ``YOLO`` (darknet53.yaml) and ``YOLOV7P`` (CSP-Darknet53), and
    ``YOLOV7P`` on ResNet-50 from ``configs/coco/r50.yaml`` (section 12
    (f)). Section 18 runs the same on ``yaml`` ``r2_50.yaml`` (YOLOV7 on
    Res2Net-50) with ``RES2NET_OTHERS``, and adds its launches to
    ``kernels``'s normalize, NMS and GridMask entries. The f32 step's loss
    terms are held within 1e-3 of the CPU's, and its gradient norm within
    1e-3; with ``f64_step`` (section 18) the gradient is held in float64
    instead (:func:`float64_step_check`). Each path's kernel launches are
    counted from 0."""
    from yolov7_d2_tpu_torch.data.device_aug import (
        PhotoDraws,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.models.build import build_model

    cfg = coco_cfg(yaml)
    name = f"YOLOV7 {yaml}" if yaml != "yolov7.yaml" else "YOLOV7"
    model = build_model(cfg, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"({label}a) {name} {size} from configs/coco/{yaml}: "
        f"{n_params / 1e6:.3f} M parameters, {model.dtype}")
    batches = [letterboxed_batch(n, gen)[:, :size, :size].contiguous()
               for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = anchor_serve(model, cfg, req.to(dev))
        log(f"({label}a) request bs {req.shape[0]}: "
            + check_detections(dets, req.shape[0], cfg, f"{name} serving"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"({label}a) {name} serving path launches: {launches}")
    for kernel in ("normalize", "nms"):
        if launches.get(kernel, 0) < len(requests):
            raise AssertionError(f"the {name} serving path launched "
                                 f"{kernel} {launches.get(kernel, 0)} times")
        if kernels is not None:
            kernels[kernel]["launches"] += launches[kernel]

    big = batches[-1].to(dev)
    head, with_kernel = anchor_serve(model, cfg, big)
    with_plain = anchor_tail(head, cfg, nms=nms_batched_plain)
    for field in ("valid", "classes", "boxes", "scores"):
        if not torch.equal(getattr(with_kernel, field),
                           getattr(with_plain, field)):
            raise AssertionError(f"{name} bs {big.shape[0]}: Detections."
                                 f"{field} of the kernel path differ from "
                                 "the plain path")
    log(f"({label}a) bs {big.shape[0]}: kernel-path Detections equal the "
        f"plain-path ones ({int(with_kernel.valid.sum())} kept)")

    # f32 on the card against the CPU at bs 1 (same modules, layout and
    # normalize kernel as bf16; only the convolutions' sum order differs)
    f32 = dataclasses.replace(cfg, amp=False)
    one = batches[0]
    if f32_px is not None:
        f32 = dataclasses.replace(f32, input_size=(f32_px, f32_px))
        one = one[:, :f32_px, :f32_px].contiguous()
    with torch.inference_mode():
        ref = build_model(f32, "cpu", SEED)(one)["outputs"]
        on_card = build_model(f32, dev, SEED)(one.to(dev))["outputs"].cpu()
        bf16 = model(one.to(dev))["outputs"].float().cpu()
    scale = float(ref.abs().max())
    err32 = float((on_card - ref).abs().max())
    err16 = float((bf16 - ref).abs().max())
    log(f"({label}a) bs 1 head outputs at {one.shape[1]} px vs float32 on "
        f"the CPU (max |ref| {scale:.4g}): float32 card max err "
        f"{err32:.4g} ({err32 / scale:.3g} of the max), bf16 {err16:.4g} on "
        f"[{card}]")
    if err32 > 1e-4 * scale or err16 > 5e-2 * scale:
        raise AssertionError(f"{name} head outputs disagree with the CPU")

    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: anchor_serve(model, cfg, x),
                      **request_timing(n))
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x), **request_timing(n))
            head = model(x)
        tail = cuda_ms(lambda: anchor_tail(head, cfg))
        log(f"{name} {size} bs {n} bf16 on [{card}]: e2e {e2e:.3f} ms = "
            f"{n * 1000 / e2e:.1f} img/s; forward-only {fwd:.3f} ms; tail "
            f"{tail:.3f} ms")
    del model, batches, big, head, with_kernel, with_plain, x
    torch.cuda.empty_cache()

    # ---- (b) training
    tcfg = dataclasses.replace(cfg, grid_mask=True, grid_mask_mode=1,
                               grid_mask_prob=0.3, mixup=True, ema=True)
    _, state, train_step, _ = build_system(tcfg, device=dev, seed=SEED)
    step = make_packed_photo_step(tcfg, train_step, seed=SEED)
    tbatches = [{k: v.to(dev) for k, v in train_batch(
        train_n, gen, size).items()} for _ in range(4)]
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(FAMILY_STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (FAMILY_STEPS - WARMUP)
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"({label}b) {name} training path launches: {launches}")
    if launches.get("grid_mask", 0) < 1:
        raise AssertionError(f"the {name} training path never launched "
                             "grid_mask")
    if kernels is not None:
        kernels["grid_mask"]["launches"] += launches["grid_mask"]
    masked = sum(m["grid_masked"] for m in metrics)
    if masked < 1:
        raise AssertionError(f"GridMask masked no image in {name} training")
    check_train_metrics(metrics, f"{name} train")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"{name} training moved no {key} tensor")
    fmt = ("total_loss", "loss_box", "loss_obj", "loss_cls", "num_fg",
           "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"({label}b) {name} train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    log(f"({label}b) {name} {size} train step bs {train_n} bf16 on [{card}]: "
        f"{step_ms:.3f} ms a step = {train_n * 1000 / step_ms:.1f} img/s "
        f"(host clock over {FAMILY_STEPS - WARMUP} steps after {WARMUP}); peak memory "
        f"{peak_gb:.3f} GB; {masked} of {train_n * len(metrics)} images "
        f"GridMask-ed; parameters, EMA and BN statistics moved")
    del state, train_step, step, before, after, metrics, tbatches
    torch.cuda.empty_cache()

    # one f32 step, card against CPU: full depth and width, small px, 2
    # images, the same weights, batch and draws; TF32 off
    scfg = dataclasses.replace(tcfg, input_size=(small, small), amp=False,
                               warmup_iters=0)
    sbatch = train_batch(2, gen, small)
    draws = PhotoDraws(
        perm=torch.tensor([1, 0]), do_mix=torch.tensor([True, False]),
        grid_params=torch.tensor([[16, 8, 3, 5, 1], [12, 6, 2, 7, 0]],
                                 dtype=torch.int32),
        do_flip=torch.tensor([False, True]))
    got = {where: photo_step(scfg, where, sbatch, draws)
           for where in ("cpu", dev)}
    (ref_m, ref_g), (card_m, card_g) = got["cpu"], got[dev]
    log(f"({label}b) {name} float32 train step at {small} px, card vs CPU: "
        + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError(f"{name} fg count differs between card and CPU")
    for k in ("total_loss", "loss_box", "loss_obj", "loss_cls") + (
            () if f64_step else ("grad_norm",)):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"{name} {k} differs between the card and "
                                 "the CPU")
    if f64_step:
        float64_step_check(dev, card, f"({label}b) {name}", scfg, sbatch,
                           draws, card_g, ref_g, fmt)

    # ---- (c) the other configurations: one request, one train step
    anchor_others_phase(dev, gen, others, label, requests[1], train_n,
                        kernels)


def anchor_others_phase(dev, gen: torch.Generator, others, label: str,
                        bs: int = 8, train_n: int = TRAIN_BATCH,
                        kernels=None) -> None:
    """One request of ``bs`` images and one train step of ``train_n`` each
    of ``others`` (name, yaml under ``configs/coco``, fields replaced) of
    the anchor-YOLO family, at each config's size, one model built for
    both (``build_system``'s, in eval mode to serve): the normalize and
    NMS kernels launched serving, GridMask in ``make_packed_photo_step``'s
    step (EMA on), launches counted from 0 and added to ``kernels``."""
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build

    for arch, other, replace in others:
        ccfg = dataclasses.replace(coco_cfg(other, **replace),
                                   grid_mask=True, ema=True)
        csize = ccfg.input_size[0]
        model, state, train_step, _ = build_system(ccfg, device=dev,
                                                   seed=SEED)
        req = letterboxed_batch(bs, gen, csize)
        build.reset_launches()
        _, dets = anchor_serve(model.eval(), ccfg, req.contiguous().to(dev))
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        summary = check_detections(dets, req.shape[0], ccfg, arch)
        step = make_packed_photo_step(ccfg, train_step, seed=SEED)
        build.reset_launches()
        state, m = step(state, {k: v.to(dev) for k, v in train_batch(
            train_n, gen, csize).items()})
        torch.cuda.synchronize()
        train_launches = dict(build.LAUNCHES)
        check_train_metrics([m], arch)
        for path, got_l, names in (("serving", serve_launches,
                                    ("normalize", "nms")),
                                   ("training", train_launches,
                                    ("grid_mask",))):
            for kernel in names:
                if got_l.get(kernel, 0) < 1:
                    raise AssertionError(f"{arch} {path} never launched "
                                         f"{kernel}")
                if kernels is not None:
                    kernels[kernel]["launches"] += got_l[kernel]
        log(f"({label}c) {arch} at {csize}: bs {req.shape[0]} {summary}, "
            "launches "
            f"{serve_launches}; one train step of {train_n}: total loss "
            f"{float(m['total_loss']):.4f}, num_fg {float(m['num_fg']):.0f},"
            f" launches {train_launches}")
        del model, state, train_step, step
        torch.cuda.empty_cache()


INSEG_DATASET = "chip_smoke_mini_coco_segm"


SPARSEINST_YAML = os.path.join(REPO, "configs", "coco", "sparseinst",
                               "sparse_inst_r50_base.yaml")


def sparseinst_cfg(**replace):
    """A ``SparseInstConfig`` from ``sparse_inst_r50_base.yaml`` (merged
    into the port's ``get_cfg``), with dataclass fields replaced."""
    from yolov7_d2_tpu_torch.engine import config_from_yaml

    return config_from_yaml(SPARSEINST_YAML, **replace)


def inseg_batch(n: int, gen: torch.Generator, dev, size: int = SIZE,
                slots: int = 100, max_inst: int = 20) -> dict:
    """A SparseInst training batch in the JAX layout: uint8 images [n,
    size, size, 3] and 1-``max_inst`` elliptic instances an image as dense
    uint8 masks [n, slots, size, size] (valid slots first), classes and
    validity; the masks are drawn on ``dev``."""
    count = torch.randint(1, max_inst + 1, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    centre = (torch.rand((n, slots, 2), generator=gen) * size).to(dev)
    radius = (8 + torch.rand((n, slots, 2), generator=gen)
              * (size // 4)).to(dev)
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    dy = ((grid - centre[..., 1:]) / radius[..., 1:]) ** 2
    dx = ((grid - centre[..., :1]) / radius[..., :1]) ** 2
    masks = (dy[..., :, None] + dx[..., None, :]) <= 1.0
    masks &= valid.to(dev)[..., None, None]
    return {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8).to(dev),
        "gt_masks": masks.to(torch.uint8),
        "gt_classes": (torch.randint(0, 80, (n, slots), generator=gen)
                       * valid).to(torch.int32).to(dev),
        "gt_valid": valid.to(dev),
    }


def sparseinst_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> the tail."""
    from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import (
        sparseinst_postprocess,
    )

    with torch.inference_mode():
        out = model(images)
        return out, sparseinst_postprocess(
            out, cfg.cls_threshold, cfg.mask_threshold, cfg.max_detections)


def check_inst_detections(dets, n: int, cfg, size: int, what: str) -> str:
    hm = size // 4
    if dets.masks.shape != (n, cfg.max_detections, hm, hm) or \
            dets.boxes.shape != (n, cfg.max_detections, 4):
        raise AssertionError(f"{what}: Detections shapes "
                             f"{tuple(dets.masks.shape)}")
    counts = dets.num_valid()
    if int(counts.min()) < 1:
        raise AssertionError(f"{what}: an image with no instance")
    if not torch.isfinite(dets.scores).all() or \
            not torch.isfinite(dets.masks).all():
        raise AssertionError(f"{what}: non-finite scores or masks")
    return f"instances per image {int(counts.min())}-{int(counts.max())}"


def sparseinst_phase(dev, card: str, gen: torch.Generator, kernels: dict,
                     requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                     size: int = SIZE, small: int = 128,
                     cli_images: int = CLI_IMAGES, **cli_opts) -> None:
    """Section 12: SparseInst R-50 at ``size`` from
    ``configs/coco/sparseinst/sparse_inst_r50_base.yaml``, full depth and
    width (ResNet-50 with FrozenBN, the FPN-PPM encoder at 256 channels,
    ``BaseIAMDecoder`` with 100 masks, 80 classes), bf16 over f32 weights
    from ``SEED``. (a) the normalize kernel at SparseInst's mean and std on
    [128, size, size, 3] against its plain version (the
    ``normalize_sparseinst`` entry); (b) serving: uint8 -> normalize kernel
    -> forward -> ``sparseinst_postprocess`` for each request size, times
    by CUDA events, ``upsample_masks_two_stage`` on one request; (c) the
    f32 forward on the card against the CPU at ``small`` px; (d) 13
    training steps of ``train_n`` images through ``build_system`` (AdamW),
    then one f32 step card against CPU; (e) ``train_inseg`` on a synthetic
    mini-COCO with polygons, the blend mosaic on: 12 steps, checkpoints,
    ``--resume``, the mask eval (``cli_opts`` override its config keys,
    ``__`` for ``.``). (f), YOLOV7P on ResNet-50, runs in section 11.
    Each path's launches are counted from 0."""
    from yolov7_d2_tpu_torch import train_inseg
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as si
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    cfg = sparseinst_cfg(input_size=(size, size))

    # ---- (a) the normalize kernel at SparseInst's statistics
    images = torch.randint(0, 256, (requests[-1], size, size, 3),
                           generator=gen, dtype=torch.uint8).to(dev)
    args = (images, si.PIXEL_MEAN, si.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at SparseInst's mean and std")
    kernels["normalize_sparseinst"] = {
        "name": "normalize_sparseinst", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_sparseinst plain"),
        # no one PyTorch call takes uint8 NHWC to (x - mean) / std in
        # channels_last
        "library_ms": None,
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
    }
    log(f"(12a) normalize at SparseInst's mean {si.PIXEL_MEAN} and std "
        f"{si.PIXEL_STD}: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> bf16 channels_last")
    del images, got, want, args

    # ---- (b) serving
    model = build_model(cfg, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"(12b) SparseInst R-50 {size} from sparse_inst_r50_base.yaml: "
        f"{n_params / 1e6:.3f} M parameters, {model.dtype}, stride_in_1x1 "
        f"{cfg.resnet.stride_in_1x1}")
    batches = [letterboxed_batch(n, gen)[:, :size, :size].contiguous()
               for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = sparseinst_serve(model, cfg, req.to(dev))
        log(f"(12b) request bs {req.shape[0]}: " + check_inst_detections(
            dets, req.shape[0], cfg, size, "SparseInst serving"))
    torch.cuda.synchronize()
    serve_launches = dict(build.LAUNCHES)
    log(f"(12b) SparseInst serving path launches: {serve_launches}")
    if serve_launches.get("normalize", 0) != len(requests):
        raise AssertionError("the SparseInst serving path launched "
                             f"normalize {serve_launches} times")
    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: sparseinst_serve(model, cfg, x),
                      **request_timing(n))
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x), **request_timing(n))
            out = model(x)
        tail = cuda_ms(lambda: si.sparseinst_postprocess(
            out, cfg.cls_threshold, cfg.mask_threshold, cfg.max_detections))
        log(f"SparseInst R-50 {size} bs {n} bf16 on [{card}]: e2e "
            f"{e2e:.3f} ms = {n * 1000 / e2e:.1f} img/s; forward-only "
            f"{fwd:.3f} ms = {n * 1000 / fwd:.1f} img/s; tail {tail:.3f} ms")
        del out
    # the two-stage upsample of one request: originals 1.5x the letterboxed
    # content (stage 2 enlarges) and 0.75x (stage 2 shrinks, antialiased)
    req = batches[1]
    _, dets = sparseinst_serve(model, cfg, req.to(dev))
    kept = 0
    t0 = time.perf_counter()
    for i in range(req.shape[0]):
        filled = (req[i] != 114).any(-1)
        vh = int(filled.any(1).nonzero().max()) + 1
        vw = int(filled.any(0).nonzero().max()) + 1
        f = 1.5 if i % 2 else 0.75
        orig = (round(vh * f), round(vw * f))
        up = si.upsample_masks_two_stage(
            dets.masks[i][dets.valid[i]], (size, size), (vh, vw), orig,
            cfg.mask_threshold)
        if up.shape[1:] != orig:
            raise AssertionError(f"two-stage upsample gave {up.shape}")
        kept += int(up.any((1, 2)).sum())
    torch.cuda.synchronize()
    log(f"(12b) upsample_masks_two_stage of bs {req.shape[0]}: "
        f"{int(dets.valid.sum())} masks, {kept} non-empty at the original "
        f"sizes, {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    del batches, dets

    # ---- (c) f32 card against CPU, full width, small px
    f32 = dataclasses.replace(cfg, amp=False, input_size=(small, small))
    one = letterboxed_batch(2, gen)[:, :small, :small].contiguous()
    with torch.inference_mode():
        ref = build_model(f32, "cpu", SEED)(one)
        on_card = build_model(f32, dev, SEED)(one.to(dev))
        bf16 = model(one.to(dev))
    gaps = []
    for k in ("cls_logits", "obj_logits", "mask_logits", "iam"):
        scale = float(ref[k].abs().max())
        err = float((on_card[k].cpu() - ref[k]).abs().max())
        err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
        gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
        if err > 1e-4 * scale:
            raise AssertionError(f"SparseInst {k} on the card differs from "
                                 f"the CPU by {err} of {scale}")
    log(f"(12c) f32 forward at {small} px, card against CPU, error over "
        "each output's max: " + ", ".join(gaps))
    del model, ref, on_card, bf16
    torch.cuda.empty_cache()

    # ---- (d) training: build_system, AdamW, 16 images at 640
    _, state, train_step, fields = build_system(cfg, device=dev, seed=SEED)
    frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [inseg_batch(train_n, gen, dev, size) for _ in range(4)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(FAMILY_STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = train_step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (FAMILY_STEPS - WARMUP)
    train_launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"(12d) SparseInst training path launches: {train_launches}")
    if train_launches.get("normalize", 0) != len(metrics):
        raise AssertionError("the SparseInst training path launched "
                             f"normalize {train_launches} times")
    kernels["normalize_sparseinst"]["launches"] = (
        serve_launches["normalize"] + train_launches["normalize"])
    for i, m in enumerate(metrics):
        for key in ("loss_ce", "loss_dice", "loss_mask", "loss_objectness",
                    "total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"SparseInst step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_inst"]) > 0:
            raise AssertionError(f"SparseInst step {i}: no instance matched")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError("SparseInst training moved no parameter")
    if not all(torch.equal(a, b)
               for a, b in zip(frozen, frozen_bn_buffers(state.model))):
        raise AssertionError("SparseInst training moved FrozenBN statistics")
    fmt = ("total_loss", "loss_ce", "loss_dice", "loss_mask",
           "loss_objectness", "num_inst", "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"(12d) SparseInst train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    iters = [int(m["match_iters"]) for m in metrics]
    slots = tbatches[0]["gt_masks"].shape[1]
    log(f"(12d) SparseInst R-50 {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
        f"{FAMILY_STEPS - WARMUP} steps after {WARMUP}, batches on the card, "
        f"{slots} mask slots an image, 1-20 valid); peak memory "
        f"{peak_gb:.3f} GB; auction rounds "
        f"a step {iters}; parameters moved, FrozenBN statistics did not")
    del state, train_step, tbatches, metrics, before, frozen
    torch.cuda.empty_cache()

    # one f32 step, card against CPU, from the same weights and batch: the
    # assignments, the loss terms and the gradient norm
    scfg = dataclasses.replace(cfg, input_size=(small, small), amp=False,
                               warmup_iters=0)
    sbatch = inseg_batch(2, gen, "cpu", small, slots=8, max_inst=6)
    got = {}
    for where in ("cpu", dev):
        model, st, ts, _ = build_system(scfg, device=where, seed=SEED)
        b = {k: v.to(where) for k, v in sbatch.items()}
        with torch.no_grad():
            out = model(b["image"])
            small_gt = si._resize(b["gt_masks"].float(), out[
                "mask_logits"].shape[-2:])
            pred, ok, _ = si.sparseinst_match(out, small_gt,
                                              b["gt_classes"], b["gt_valid"])
        _, m = ts(st, b)
        got[str(where)] = ({k: float(v) for k, v in m.items()},
                           pred.cpu(), ok.cpu())
    (ref_m, ref_p, ref_ok), (card_m, card_p, card_ok) = (
        got["cpu"], got[str(dev)])
    log(f"(12d) SparseInst f32 train step at {small} px, card vs CPU: "
        + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if not (torch.equal(card_p, ref_p) and torch.equal(card_ok, ref_ok)):
        raise AssertionError("SparseInst assignments differ between the "
                             "card and the CPU")
    for k in ("total_loss", "loss_ce", "loss_dice", "loss_mask",
              "loss_objectness", "grad_norm"):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"SparseInst {k} differs between the card "
                                 "and the CPU")
    del model, st, ts
    torch.cuda.empty_cache()

    # ---- (e) the CLI: train_inseg on a mini-COCO with polygons
    work = os.path.join(REPO, "build", "chip_smoke_inseg")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=cli_images, segm=True)
    register_coco_instances(INSEG_DATASET, {}, js, img_dir)
    out_dir = os.path.join(work, "out")
    opts = {"DATASETS.TRAIN": (INSEG_DATASET,),
            "DATASETS.TEST": (INSEG_DATASET,), "OUTPUT_DIR": out_dir,
            "SEED": SEED, "SOLVER.IMS_PER_BATCH": train_n,
            "SOLVER.MAX_ITER": 12, "SOLVER.CHECKPOINT_PERIOD": 6,
            "INPUT.MOSAIC.ENABLED": True, "INPUT.INPUT_SIZE": [size, size],
            "INPUT.MOSAIC.MOSAIC_HEIGHT": size,
            "INPUT.MOSAIC.MOSAIC_WIDTH": size,
            **{k.replace("__", "."): v for k, v in cli_opts.items()}}

    def cli(*flags, **more):
        argv = ["--config-file", SPARSEINST_YAML, *flags]
        more = {k.replace("__", "."): v for k, v in more.items()}
        for k, v in dict(opts, **more).items():
            argv += [k, v if isinstance(v, str) else repr(v)]
        return default_argument_parser().parse_args(argv)

    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run = train_inseg.main(cli())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        latest = run.storage.latest()
        for key in ("total_loss", "loss_ce", "loss_dice", "loss_mask",
                    "loss_objectness", "grad_norm"):
            if not math.isfinite(latest.get(key, float("nan"))):
                raise AssertionError(f"train_inseg: {key} = "
                                     f"{latest.get(key)}")
        if launches.get("normalize", 0) != 12:
            raise AssertionError(f"train_inseg launches {launches}")
        median = run.storage.median("time_per_iter")
        del run
        resumed = train_inseg.main(cli("--resume", SOLVER__MAX_ITER=14))
        if resumed.start_iter != 12 or resumed.storage.iter != 14:
            raise AssertionError(f"train_inseg --resume ran "
                                 f"{resumed.start_iter} -> "
                                 f"{resumed.storage.iter}, not 12 -> 14")
        del resumed
        build.reset_launches()
        t0 = time.perf_counter()
        results = train_inseg.main(cli("--eval-only"))
        eval_s = time.perf_counter() - t0
        missing = [k for k in ("AP", "AP50", "AP75", "APs", "APm", "APl",
                               "AR100") if k not in results]
        if missing:
            raise AssertionError(f"COCOMaskEvaluator: no {missing}")
        log(f"(12e) train_inseg on [{card}], {train_n} images a step, blend "
            f"mosaic on: time_per_iter median {median * 1e3:.3f} ms = "
            f"{train_n / median:.1f} img/s; 12 steps and 2 checkpoints in "
            f"{wall:.2f} s (build included); launches {launches}; --resume "
            f"12 -> 14; segm eval of {cli_images} images in {eval_s:.2f} s "
            f"(launches {dict(build.LAUNCHES)}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in results.items()))
    finally:
        DatasetCatalog.remove(INSEG_DATASET)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


DETR_DATASET = "chip_smoke_mini_coco_detr"
DETR_DIR = os.path.join(REPO, "configs", "coco", "detr")
DETR_SIZE = 800
DETR_TRAIN_BATCH = 8  # one card's share of IMS_PER_BATCH 32 over 4 cards
DETR_MODELS = (("DETR", "detr_256_6_6_r50.yaml"),
               ("AnchorDETR", "anchordetr_r50.yaml"))


def detr_cfg(yaml: str, **replace):
    """A ``DetrConfig`` from ``configs/coco/detr/<yaml>`` (merged into the
    port's ``get_cfg``), with dataclass fields replaced."""
    from yolov7_d2_tpu_torch.engine import config_from_yaml

    return config_from_yaml(os.path.join(DETR_DIR, yaml), **replace)


def detr_tail(out, cfg):
    """The family's tail (``detr_variants.detr_tail``: ``detr_postprocess``
    for C + 1 logits, ``anchor_detr_postprocess`` for the focal heads' C)
    -> ``Detections`` of ``cfg.max_detections``."""
    from yolov7_d2_tpu_torch.models.meta_arch import detr_variants

    tail = detr_variants.detr_tail(cfg)
    with torch.inference_mode():
        return tail(out, cfg.input_size, cfg.max_detections)


def detr_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> the tail."""
    with torch.inference_mode():
        out = model(images)
    return out, detr_tail(out, cfg)


def detr_batch(n: int, gen: torch.Generator, dev, size: int = DETR_SIZE,
               slots: int = 100, max_boxes: int = 20) -> dict:
    """A DETR training batch in the JAX layout: uint8 images [n, size,
    size, 3] and 1-``max_boxes`` xyxy boxes in pixels an image (valid
    slots first), classes and validity."""
    count = torch.randint(1, max_boxes + 1, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    xy = torch.rand((n, slots, 2), generator=gen) * (size - 16)
    wh = 8 + torch.rand((n, slots, 2), generator=gen) * (size // 2)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    return {k: v.to(dev) for k, v in {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": boxes * valid[..., None],
        "gt_classes": (torch.randint(0, 80, (n, slots), generator=gen)
                       * valid).to(torch.int32),
        "gt_valid": valid}.items()}


def level_assignments(out, batch, cfg):
    """Every decoder level's assignment, as ``detr_losses`` makes them (one
    auction over the stacked levels): ``(pred_of_gt, ok)`` [L * B, G],
    the last level first."""
    from yolov7_d2_tpu_torch.models.meta_arch import detr as dm

    gt = dm.normalized_gt_boxes(batch["gt_boxes"], cfg.input_size)
    logits = torch.cat([out["pred_logits"][None], out["aux_logits"]])
    boxes = torch.cat([out["pred_boxes"][None], out["aux_boxes"]])
    n = logits.shape[0]
    with torch.no_grad():
        pred, ok, _ = dm.detr_match(
            logits.flatten(0, 1), boxes.flatten(0, 1), gt.repeat(n, 1, 1),
            batch["gt_classes"].repeat(n, 1), batch["gt_valid"].repeat(n, 1),
            use_focal=cfg.use_focal)
    return pred, ok


def device_busy_ms(fn, calls: int = 3) -> tuple:
    """(device busy ms a call, window ms a call) of ``fn`` under
    torch.profiler: the kernels' summed device time against CUDA events
    around the traced calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    busy = sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == torch.autograd.DeviceType.CUDA
               and "#" not in k.key) / 1000.0
    return busy / calls, start.elapsed_time(end) / calls


def detr_phase(dev, card: str, gen: torch.Generator, kernels: dict,
               requests=REQUEST_BATCHES, train_n: int = DETR_TRAIN_BATCH,
               size: int = DETR_SIZE, small: int = 128,
               cli_images: int = CLI_IMAGES, steps: int = FAMILY_STEPS,
               **cli_opts) -> None:
    """Section 13: DETR R-50 (``configs/coco/detr/detr_256_6_6_r50.yaml``)
    and AnchorDETR R-50 (``anchordetr_r50.yaml``, RCDA, 300 x 3 queries)
    at ``size``, full depth and width, 80 classes, bf16 over f32 weights
    from ``SEED``. (a) the normalize kernel at DETR's mean and std on
    [128, size, size, 3] against its plain version (the ``normalize_detr``
    entry); then for each model serving, uint8 -> normalize kernel ->
    forward -> the tail, for each request size (one launch a request,
    times by CUDA events, the device's busy share at the largest), and the
    kernel path's ``Detections`` against the plain path's (float input)
    at bs 8; (b) the f32 outputs on the card against the CPU at ``small``
    px within 1e-4 of each output's max, bf16 within 5e-2; (c) ``steps``
    training steps of ``train_n`` images through ``build_system`` (AdamW,
    the set criterion over 6 levels, dropout 0.1 for DETR): finite losses
    at every level, matched counts equal to the valid gts, parameters
    moved, FrozenBN statistics unmoved, ms a step, peak memory, auction
    rounds; one f32 step at dropout 0 on the card against the CPU
    (assignments equal at every level, losses and grad norm within 1e-3);
    (d) ``train_transformer`` on a synthetic mini-COCO of ``cli_images``
    JPEGs, the crop branch on: 12 steps with checkpoints at 6 and 12,
    ``--resume`` to 14 (``cli_opts`` override its config keys, ``__`` for
    ``.``). Each path's launches are counted from 0
    (:func:`detr_model_paths`, :func:`detr_cli_run`)."""
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.meta_arch import detr as dm

    # ---- (a) the normalize kernel at DETR's statistics
    images = torch.randint(0, 256, (requests[-1], size, size, 3),
                           generator=gen, dtype=torch.uint8).to(dev)
    args = (images, dm.PIXEL_MEAN, dm.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at DETR's mean and std")
    kernels["normalize_detr"] = {
        "name": "normalize_detr", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_detr plain"),
        # no one PyTorch call takes uint8 NHWC to (x - mean) / std in
        # channels_last
        "library_ms": None,
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
        "launches": 0,
    }
    log(f"(13a) normalize at DETR's mean {dm.PIXEL_MEAN} and std "
        f"{dm.PIXEL_STD}: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> bf16 channels_last")
    del images, got, want, args
    batches = [letterboxed_batch(n, gen, size) for n in requests]

    for name, yaml in DETR_MODELS:
        detr_model_paths(dev, card, gen, kernels, name, yaml, "13", batches,
                         train_n, size, small, steps)
    detr_cli_run(dev, card, kernels, "13d", "DETR", DETR_MODELS[0][1],
                 train_n, size, cli_images, **cli_opts)


def detr_model_paths(dev, card: str, gen: torch.Generator, kernels: dict,
                     name: str, yaml: str, label: str, batches,
                     train_n: int = DETR_TRAIN_BATCH, size: int = DETR_SIZE,
                     small: int = 128, steps: int = FAMILY_STEPS) -> None:
    """The paths of one model of the DETR family from ``configs/coco/detr/
    <yaml>`` at ``size`` (sections 13 and 19): serving ``batches`` (uint8
    -> normalize kernel -> forward -> the tail, one launch a request, times
    by CUDA events, the device's busy share at the largest, the kernel
    path's ``Detections`` against the plain path's at the second), the f32
    card against the CPU at ``small`` px, ``steps`` training steps of
    ``train_n`` images through ``build_system`` and one f32 step at dropout
    0 on the card against the CPU. The normalize launches are added to
    ``kernels``'s ``normalize_detr`` entry."""
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )
    from yolov7_d2_tpu_torch.models.build import build_model

    requests = [b.shape[0] for b in batches]
    cfg = detr_cfg(yaml)
    if cfg.input_size != (size, size):
        cfg = dataclasses.replace(cfg, input_size=(size, size))
    model = build_model(cfg, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"({label}a) {name} R-50 {size} from {yaml}: {n_params / 1e6:.3f} M "
        f"parameters, {model.dtype}, {cfg.enc_layers} + "
        f"{cfg.dec_layers} layers, "
        + (f"{cfg.num_query_position} x {cfg.num_query_pattern} "
           f"queries, {cfg.attention_type}"
           if cfg.meta_architecture == "AnchorDetr" else
           f"{cfg.num_queries} queries"))
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = detr_serve(model, cfg, req.to(dev))
        log(f"({label}a) {name} request bs {req.shape[0]}: " +
            check_detections(dets, req.shape[0], cfg, f"{name} serving"))
    torch.cuda.synchronize()
    serve_launches = dict(build.LAUNCHES)
    if serve_launches.get("normalize", 0) != len(requests):
        raise AssertionError(f"the {name} serving path launched "
                             f"normalize {serve_launches} times")
    kernels["normalize_detr"]["launches"] += serve_launches["normalize"]
    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: detr_serve(model, cfg, x),
                      **request_timing(n))
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x), **request_timing(n))
            out = model(x)
        tail = cuda_ms(lambda: detr_tail(out, cfg))
        extra = ""
        if n == requests[-1]:
            busy, window = device_busy_ms(
                lambda: detr_serve(model, cfg, x))
            extra = (f"; device busy {busy:.3f} ms a call = "
                     f"{100 * busy / e2e:.1f}% of the untraced call "
                     f"(traced {window:.3f} ms)")
        log(f"{name} R-50 {size} bs {n} bf16 on [{card}]: e2e "
            f"{e2e:.3f} ms = {n * 1000 / e2e:.1f} img/s; forward-only "
            f"{fwd:.3f} ms = {n * 1000 / fwd:.1f} img/s; tail "
            f"{tail:.3f} ms{extra}")
        del out
    # the kernel path against the plain path (float input, the plain
    # normalize): the same Detections
    x = batches[1].to(dev)
    _, dets = detr_serve(model, cfg, x)
    _, plain = detr_serve(model, cfg, x.float())
    for f in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(getattr(dets, f), getattr(plain, f)):
            raise AssertionError(f"{name}: the kernel path's {f} differ "
                                 "from the plain path's")
    log(f"({label}a) {name} bs {x.shape[0]}: the kernel path's Detections "
        "equal the plain path's")

    # ---- (b) f32 card against CPU, full width, small px
    f32 = dataclasses.replace(cfg, amp=False, input_size=(small, small))
    one = letterboxed_batch(2, gen, small)
    with torch.inference_mode():
        ref = build_model(f32, "cpu", SEED)(one)
        on_card = build_model(f32, dev, SEED)(one.to(dev))
        bf16 = model(one.to(dev))
    gaps = []
    for k in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        scale = float(ref[k].abs().max())
        err = float((on_card[k].cpu() - ref[k]).abs().max())
        err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
        gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
        if err > 1e-4 * scale or err16 > 5e-2 * scale:
            raise AssertionError(f"{name} {k} on the card differs from "
                                 f"the CPU by {err} (bf16 {err16}) of "
                                 f"{scale}")
    log(f"({label}b) {name} f32 forward at {small} px, card against CPU, "
        "error over each output's max: " + ", ".join(gaps))
    del model, ref, on_card, bf16
    torch.cuda.empty_cache()

    # ---- (c) training: build_system, AdamW, train_n images at size
    _, state, train_step, _ = build_system(cfg, device=dev, seed=SEED)
    frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [detr_batch(train_n, gen, dev, size) for _ in range(4)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    warm = min(WARMUP, steps - 1)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = train_step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
    train_launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if train_launches.get("normalize", 0) != steps:
        raise AssertionError(f"the {name} training path launched "
                             f"normalize {train_launches} times")
    kernels["normalize_detr"]["launches"] += train_launches["normalize"]
    prefixes = [""] + [f"aux{i}_" for i in range(cfg.dec_layers - 1)]
    for i, m in enumerate(metrics):
        valid = int(tbatches[i % 4]["gt_valid"].sum())
        for p in prefixes:
            for key in ("loss_ce", "loss_bbox", "loss_giou"):
                if not bool(torch.isfinite(m[p + key])):
                    raise AssertionError(f"{name} step {i}: {p}{key} = "
                                         f"{float(m[p + key])}")
            if int(m[p + "num_matched"]) != valid:
                raise AssertionError(
                    f"{name} step {i}: {p}num_matched "
                    f"{int(m[p + 'num_matched'])}, {valid} valid gts")
        for key in ("total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"{name} step {i}: {key} = "
                                     f"{float(m[key])}")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError(f"{name} training moved no parameter")
    if not all(torch.equal(a, b)
               for a, b in zip(frozen, frozen_bn_buffers(state.model))):
        raise AssertionError(f"{name} training moved FrozenBN "
                             "statistics")
    fmt = ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
           "aux0_loss_ce", "num_matched", "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"({label}c) {name} train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    rounds = [int(m["match_iters"]) for m in metrics]
    log(f"({label}c) {name} R-50 {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
        f"{steps - warm} steps after {warm}, batches on the card, 100 "
        f"box slots an image, 1-20 valid, {len(prefixes)} levels "
        f"matched in one auction); peak memory {peak_gb:.3f} GB; "
        f"auction rounds a step {rounds}; launches {train_launches}; "
        "every level's matched count = the valid gts; parameters moved, "
        "FrozenBN statistics did not")
    del state, train_step, tbatches, metrics, before, frozen
    torch.cuda.empty_cache()

    # one f32 step at dropout 0, card against CPU, from the same
    # weights and batch: every level's assignments, the losses, the
    # gradient norm
    scfg = dataclasses.replace(cfg, input_size=(small, small), amp=False,
                               warmup_iters=0, dropout=0.0)
    sbatch = detr_batch(2, gen, "cpu", small, slots=8, max_boxes=6)
    got = {}
    for where in ("cpu", dev):
        model, st, ts, _ = build_system(scfg, device=where, seed=SEED)
        b = {k: v.to(where) for k, v in sbatch.items()}
        with torch.no_grad():
            pred, ok = level_assignments(model(b["image"]), b, scfg)
        _, m = ts(st, b)
        got[str(where)] = ({k: float(v) for k, v in m.items()},
                           pred.cpu(), ok.cpu())
    (ref_m, ref_p, ref_ok), (card_m, card_p, card_ok) = (
        got["cpu"], got[str(dev)])
    keys = ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
            "aux4_loss_ce", "grad_norm")
    log(f"({label}c) {name} f32 train step at {small} px, card vs CPU: "
        + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}"
                    for k in keys)
        + f"; matched {int(card_ok.sum())} over {len(prefixes)} levels")
    if not (torch.equal(card_p, ref_p) and torch.equal(card_ok, ref_ok)):
        raise AssertionError(f"{name} assignments differ between the "
                             "card and the CPU")
    for k in ref_m:
        if "loss" in k or k == "grad_norm":
            if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
                raise AssertionError(f"{name} {k} differs between the "
                                     "card and the CPU")
    del model, st, ts
    torch.cuda.empty_cache()


def detr_cli_run(dev, card: str, kernels: dict, label: str, name: str,
                 yaml: str, train_n: int = DETR_TRAIN_BATCH,
                 size: int = DETR_SIZE, cli_images: int = CLI_IMAGES,
                 steps: int = 12, resume: bool = True, **cli_opts) -> None:
    """``train_transformer`` on ``configs/coco/detr/<yaml>`` and a
    synthetic mini-COCO of ``cli_images`` JPEGs, the crop branch on:
    ``steps`` steps with checkpoints at half and at the end, finite losses
    at the last level and the first auxiliary one, one normalize launch a
    step (added to ``kernels``'s ``normalize_detr`` entry), and with
    ``resume`` ``--resume`` to ``steps`` + 2 (``cli_opts`` override its
    config keys, ``__`` for ``.``)."""
    from yolov7_d2_tpu_torch import train_transformer
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    work = os.path.join(REPO, "build", "chip_smoke_detr")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=cli_images)
    register_coco_instances(DETR_DATASET, {}, js, img_dir)
    out_dir = os.path.join(work, "out")
    yaml = os.path.join(DETR_DIR, yaml)
    opts = {"DATASETS.TRAIN": (DETR_DATASET,), "OUTPUT_DIR": out_dir,
            "SEED": SEED, "SOLVER.IMS_PER_BATCH": train_n,
            "SOLVER.MAX_ITER": steps, "SOLVER.CHECKPOINT_PERIOD": steps // 2,
            "INPUT.CROP.ENABLED": True, "INPUT.INPUT_SIZE": [size, size],
            **{k.replace("__", "."): v for k, v in cli_opts.items()}}

    def cli(*flags, **more):
        argv = ["--config-file", yaml, *flags]
        more = {k.replace("__", "."): v for k, v in more.items()}
        for k, v in dict(opts, **more).items():
            argv += [k, v if isinstance(v, str) else repr(v)]
        return default_argument_parser().parse_args(argv)

    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run = train_transformer.main(cli())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        latest = run.storage.latest()
        for key in ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
                    "aux4_loss_giou", "grad_norm"):
            if not math.isfinite(latest.get(key, float("nan"))):
                raise AssertionError(f"train_transformer: {key} = "
                                     f"{latest.get(key)}")
        if launches.get("normalize", 0) != steps:
            raise AssertionError(f"train_transformer launches {launches}")
        kernels["normalize_detr"]["launches"] += launches["normalize"]
        ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
        if len(ckpts) != 2:
            raise AssertionError(f"train_transformer checkpoints {ckpts}")
        median = run.storage.median("time_per_iter")
        del run
        if resume:
            resumed = train_transformer.main(cli(
                "--resume", SOLVER__MAX_ITER=steps + 2))
            if resumed.start_iter != steps or \
                    resumed.storage.iter != steps + 2:
                raise AssertionError(f"train_transformer --resume ran "
                                     f"{resumed.start_iter} -> "
                                     f"{resumed.storage.iter}, not {steps}"
                                     f" -> {steps + 2}")
            del resumed
        log(f"({label}) train_transformer {name} on [{card}], {train_n} "
            f"images a step, the crop branch on: time_per_iter median "
            f"{median * 1e3:.3f} ms = {train_n / median:.1f} img/s; {steps} "
            f"steps and checkpoints {ckpts} in {wall:.2f} s (build "
            f"included); launches {launches}"
            + (f"; --resume {steps} -> {steps + 2}" if resume else ""))
    finally:
        DatasetCatalog.remove(DETR_DATASET)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


KPTS_MODELS = (("Swin-T", "yolox_kpts_swin.yaml", {}),
               ("CSPDarknet-X", "yolox_kpts.yaml", {}),
               ("PVTv2-b1", "yolox_kpts.yaml",
                {"backbone": "build_pvt_v2_backbone"}))
KPTS_YOLOV7 = ("swin_t.yaml", "pvt_v2_b0.yaml")
BOX_KEYS = ("AP", "AP50", "AP75", "AR100")


def kpts_tail(head, cfg, nms=None):
    """``yolox_kpts_postprocess`` with the NMS kernel unless ``nms``."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolox_kpts import (
        yolox_kpts_postprocess,
    )

    with torch.inference_mode():
        return yolox_kpts_postprocess(
            head, cfg.conf_threshold, cfg.nms_threshold, cfg.max_detections,
            cfg.pre_nms_topk, **({} if nms is None else {"nms": nms}))


def kpts_serve(model, cfg, images):
    """uint8 batch -> the normalize kernel and the model -> the tail."""
    with torch.inference_mode():
        head = model(images)
    return head, kpts_tail(head, cfg)


def kpts_batch(n: int, gen: torch.Generator, dev, size: int = SIZE,
               slots: int = 100, max_persons: int = 8) -> dict:
    """A YOLOX-KPTS training batch: uint8 images, 1-``max_persons``
    persons an image (valid slots first) with 17 keypoints each inside
    their box, visible, occluded or unlabelled ((0, 0) with v 0)."""
    count = torch.randint(1, max_persons + 1, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    xy = torch.rand((n, slots, 2), generator=gen) * (size * 0.7)
    wh = 32 + torch.rand((n, slots, 2), generator=gen) * (size * 0.3)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1)
    u = torch.rand((n, slots, 17, 2), generator=gen)
    pts = boxes[..., None, :2] + u * (boxes[..., None, 2:]
                                      - boxes[..., None, :2])
    v = torch.randint(0, 3, (n, slots, 17), generator=gen).float()
    kp = torch.cat([torch.where(v[..., None] > 0, pts, 0.0), v[..., None]],
                   -1)
    return {k: t.to(dev) for k, t in {
        "image": torch.randint(0, 256, (n, size, size, 3), generator=gen,
                               dtype=torch.uint8),
        "gt_boxes": boxes * valid[..., None],
        "gt_classes": torch.zeros((n, slots), dtype=torch.int32),
        "gt_valid": valid,
        "gt_keypoints": kp * valid[..., None, None]}.items()}


def check_kpt_detections(dets, n: int, cfg, what: str) -> str:
    summary = check_detections(dets, n, cfg, what)
    kp = dets.keypoints
    if kp is None or tuple(kp.shape) != (n, cfg.max_detections,
                                         cfg.num_keypoints, 3):
        raise AssertionError(f"{what}: keypoints "
                             f"{None if kp is None else tuple(kp.shape)}")
    kept = kp[dets.valid]
    if not torch.isfinite(kept).all() or float(kept[..., 2].min()) < 0 \
            or float(kept[..., 2].max()) > 1:
        raise AssertionError(f"{what}: keypoints not finite or scores out "
                             "of [0, 1]")
    return summary


def yolox_kpts_phase(dev, card: str, gen: torch.Generator, kernels: dict,
                     requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                     size: int = SIZE, small: int = 128,
                     eval_images: int = CLI_IMAGES,
                     steps: int = FAMILY_STEPS, **eval_opts) -> None:
    """Section 14: YOLOX-KPTS at ``size``, full depth and width, one class,
    17 keypoints, bf16 over f32 weights from ``SEED``. (a) serving on
    ``yolox_kpts_swin.yaml`` (Swin-T), then ``yolox_kpts.yaml``
    (CSPDarknet-X) and PVTv2-b1: uint8 -> normalize kernel -> forward ->
    ``yolox_kpts_postprocess`` -> NMS kernel, for each request size (one
    launch of each a request; e2e, forward and tail by CUDA events, the
    device's busy share at the largest), the kernel path's ``Detections``,
    keypoints included, equal to the plain path's at bs 8; (b) each model's
    f32 outputs on the card against the CPU at ``small`` px within 1e-4 of
    the max, bf16 within 5e-2; (c) ``steps`` training steps of
    ``train_n`` images through ``build_system`` on the Swin config (1-8
    persons of 17 keypoints an image): finite losses, foreground anchors,
    ``loss_kpt`` > 0, parameters moved, ms a step, peak memory, normalize
    launches; one f32 step at ``small`` px on the card against the CPU
    (fg count equal, losses and grad norm within 1e-3); (d) ``eval_coco``
    on a synthetic mini-COCO-keypoints of ``eval_images`` JPEGs: the box
    and ``kpt_`` keys, then the same keys from ``--weights`` of a saved
    state dict (``eval_opts`` override its config keys, ``__`` for
    ``.``); (e) YOLOV7 on ``swin_t.yaml`` and ``pvt_v2_b0.yaml``, full
    depth: one request and one train step each. The launches of (a), (c)
    and (d) go into the normalize and NMS entries."""
    from yolov7_d2_tpu_torch import eval_coco
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import KPTS_FIELDS, build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.models.build import build_model

    batches = [letterboxed_batch(n, gen, size) for n in requests]
    for name, yaml, replace in KPTS_MODELS:
        # ---- (a) serving
        cfg = coco_cfg(yaml, **replace)
        model = build_model(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"(14a) YOLOX-KPTS {name} {size} from {yaml}: "
            f"{n_params / 1e6:.3f} M parameters, {model.dtype}, "
            f"{cfg.num_keypoints} keypoints")
        torch.cuda.synchronize()
        build.reset_launches()
        for req in batches:
            _, dets = kpts_serve(model, cfg, req.to(dev))
            log(f"(14a) {name} request bs {req.shape[0]}: " +
                check_kpt_detections(dets, req.shape[0], cfg,
                                     f"YOLOX-KPTS {name} serving"))
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        for k in ("normalize", "nms"):
            if launches.get(k, 0) != len(requests):
                raise AssertionError(f"the YOLOX-KPTS {name} serving path "
                                     f"launched {k} {launches} times")
            kernels[k]["launches"] += launches[k]
        log(f"(14a) {name} serving path launches, counted from 0: "
            f"{launches}")
        for req in batches:
            n = req.shape[0]
            x = req.to(dev)
            e2e = cuda_ms(lambda: kpts_serve(model, cfg, x),
                          **request_timing(n))
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(x), **request_timing(n))
                head = model(x)
            tail = cuda_ms(lambda: kpts_tail(head, cfg))
            extra = ""
            if n == requests[-1]:
                busy, window = device_busy_ms(
                    lambda: kpts_serve(model, cfg, x))
                extra = (f"; device busy {busy:.3f} ms a call = "
                         f"{100 * busy / e2e:.1f}% of the untraced call "
                         f"(traced {window:.3f} ms)")
            log(f"YOLOX-KPTS {name} {size} bs {n} bf16 on [{card}]: e2e "
                f"{e2e:.3f} ms = {n * 1000 / e2e:.1f} img/s; forward-only "
                f"{fwd:.3f} ms = {n * 1000 / fwd:.1f} img/s; tail "
                f"{tail:.3f} ms{extra}")
            del head
        # the kernel path against the plain path (float input, the plain
        # normalize; the plain NMS): the same Detections, keypoints too
        x = batches[1].to(dev)
        _, dets = kpts_serve(model, cfg, x)
        with torch.inference_mode():
            plain = kpts_tail(model(x.float()), cfg, nms=nms_batched_plain)
        for f in ("boxes", "scores", "classes", "valid", "keypoints"):
            if not torch.equal(getattr(dets, f), getattr(plain, f)):
                raise AssertionError(f"YOLOX-KPTS {name}: the kernel path's "
                                     f"{f} differ from the plain path's")
        log(f"(14a) {name} bs {x.shape[0]}: the kernel path's Detections "
            f"(keypoints included) equal the plain path's "
            f"({int(dets.valid.sum())} kept)")

        # ---- (b) f32 card against CPU, full width, small px
        f32 = dataclasses.replace(cfg, amp=False)
        one = letterboxed_batch(2, gen, small)
        with torch.inference_mode():
            ref = build_model(f32, "cpu", SEED)(one)
            on_card = build_model(f32, dev, SEED)(one.to(dev))
            bf16 = model(one.to(dev))
        gaps = []
        for k in ("outputs", "kpts"):
            scale = float(ref[k].abs().max())
            err = float((on_card[k].cpu() - ref[k]).abs().max())
            err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
            gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
            if err > 1e-4 * scale or err16 > 5e-2 * scale:
                raise AssertionError(f"YOLOX-KPTS {name} {k} on the card "
                                     f"differs from the CPU by {err} (bf16 "
                                     f"{err16}) of {scale}")
        log(f"(14b) {name} f32 forward at {small} px, card against CPU, "
            "error over each output's max: " + ", ".join(gaps))
        del model, ref, on_card, bf16, x, dets, plain
        torch.cuda.empty_cache()

    # ---- (c) training on the Swin config: build_system, train_n images
    cfg = coco_cfg(KPTS_MODELS[0][1])
    _, state, train_step, fields = build_system(cfg, device=dev, seed=SEED)
    if fields != KPTS_FIELDS:
        raise AssertionError(f"YOLOX-KPTS batch fields {fields}")
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [kpts_batch(train_n, gen, dev, size) for _ in range(4)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    warm = min(WARMUP, steps - 1)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = train_step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches.get("normalize", 0) != steps:
        raise AssertionError(f"the YOLOX-KPTS training path launched "
                             f"normalize {launches} times")
    kernels["normalize"]["launches"] += launches["normalize"]
    keys = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "loss_kpt",
            "loss_kpt_vis", "grad_norm")
    for i, m in enumerate(metrics):
        for key in keys:
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"YOLOX-KPTS step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_fg"]) > 1.0 or not float(m["loss_kpt"]) > 0:
            raise AssertionError(f"YOLOX-KPTS step {i}: num_fg "
                                 f"{float(m['num_fg'])}, loss_kpt "
                                 f"{float(m['loss_kpt'])}")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError("YOLOX-KPTS training moved no parameter")
    for i in (0, len(metrics) - 1):
        log(f"(14c) YOLOX-KPTS Swin-T train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in keys + ("num_fg",)))
    log(f"(14c) YOLOX-KPTS Swin-T {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
        f"{steps - warm} steps after {warm}, batches on the card, 100 "
        f"slots, 1-8 persons of 17 keypoints an image, SimOTA over all "
        f"anchors); peak memory {peak_gb:.3f} GB; launches {launches}; "
        "parameters moved")
    del state, train_step, tbatches, metrics, before
    torch.cuda.empty_cache()

    # one f32 step, card against CPU, from the same weights and batch
    scfg = dataclasses.replace(cfg, input_size=(small, small), amp=False,
                               warmup_iters=0)
    sbatch = kpts_batch(2, gen, "cpu", small, slots=8, max_persons=4)
    got = {}
    for where in ("cpu", dev):
        _, st, ts, _ = build_system(scfg, device=where, seed=SEED)
        _, m = ts(st, {k: v.to(where) for k, v in sbatch.items()})
        got[str(where)] = {k: float(v) for k, v in m.items()}
    ref_m, card_m = got["cpu"], got[str(dev)]
    log(f"(14c) YOLOX-KPTS Swin-T f32 train step at {small} px, card vs "
        "CPU: " + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}"
                            for k in keys + ("num_fg",)))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError("YOLOX-KPTS fg count differs between the card "
                             "and the CPU")
    for k in keys:
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"YOLOX-KPTS {k} differs between the card "
                                 "and the CPU")
    del st, ts
    torch.cuda.empty_cache()

    # ---- (d) eval_coco on a synthetic mini-COCO-keypoints
    work = os.path.join(REPO, "build", "chip_smoke_kpts")
    shutil.rmtree(work, ignore_errors=True)
    try:
        js, img_dir = write_mini_coco(work, n=eval_images, keypoints=True)
        yaml = os.path.join(REPO, "configs", "coco", KPTS_MODELS[0][1])
        base = ["--config-file", yaml, "--json", js, "--image-root",
                img_dir, "--batch", "8"]
        opts = []
        for k, v in eval_opts.items():
            opts += [k.replace("__", "."), v if isinstance(v, str)
                     else repr(v)]
        parse = eval_coco.build_argument_parser().parse_args
        printed = {}
        for run, flags in (("random", []), ("--weights", None)):
            if flags is None:
                path = os.path.join(work, "weights.pth")
                torch.save({"model": build_model(cfg, "cpu",
                                                 SEED + 1).state_dict()},
                           path)
                flags = ["--weights", path]
            torch.cuda.synchronize()
            build.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = eval_coco.main(parse(base + flags + opts))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
            text = buf.getvalue()
            keys_seen = [line.split(":")[0] for line in text.splitlines()
                         if ": " in line and not line.startswith("ported")]
            want = list(BOX_KEYS) + [f"kpt_{k}" for k in BOX_KEYS]
            missing = [k for k in want if k not in keys_seen]
            if missing or res["keypoints"] is None:
                raise AssertionError(f"eval_coco ({run}) printed {keys_seen}")
            if run == "--weights" and "ported" not in text:
                raise AssertionError("eval_coco --weights loaded nothing")
            batches_n = -(-eval_images // 8)
            for k in ("normalize", "nms"):
                if launches.get(k, 0) != batches_n:
                    raise AssertionError(f"eval_coco ({run}) launched {k} "
                                         f"{launches} times")
                kernels[k]["launches"] += launches[k]
            printed[run] = keys_seen
            log(f"(14d) eval_coco {run} on [{card}], {eval_images} images "
                f"(640x480) in batches of 8, Swin-T: {wall:.2f} s "
                f"(build included); launches {launches}; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res["bbox"].items()
                    if k in BOX_KEYS) + "; " + ", ".join(
                    f"kpt_{k} {v:.4f}" for k, v in res["keypoints"].items()
                    if k in BOX_KEYS))
        if printed["random"] != printed["--weights"]:
            raise AssertionError("eval_coco --weights printed other keys")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- (e) YOLOV7 on Swin-T and PVTv2-b0: one request, one train step
    for yaml in KPTS_YOLOV7:
        ccfg = coco_cfg(yaml)
        model = build_model(ccfg, dev, SEED)
        req = batches[1]
        build.reset_launches()
        _, dets = anchor_serve(model, ccfg, req.to(dev))
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        summary = check_detections(dets, req.shape[0], ccfg, yaml)
        del model
        ccfg = dataclasses.replace(ccfg, grid_mask=True, ema=True)
        _, state, train_step, _ = build_system(ccfg, device=dev, seed=SEED)
        step = make_packed_photo_step(ccfg, train_step, seed=SEED)
        build.reset_launches()
        state, m = step(state, {k: v.to(dev) for k, v in train_batch(
            train_n, gen, size).items()})
        torch.cuda.synchronize()
        train_launches = dict(build.LAUNCHES)
        check_train_metrics([m], yaml)
        for path, got_l, names in (("serving", serve_launches,
                                    ("normalize", "nms")),
                                   ("training", train_launches,
                                    ("grid_mask",))):
            for name in names:
                if got_l.get(name, 0) < 1:
                    raise AssertionError(f"YOLOV7 {yaml} {path} never "
                                         f"launched {name}")
        log(f"(14e) YOLOV7 {yaml}: bs {req.shape[0]} {summary}, launches "
            f"{serve_launches}; one train step of {train_n}: total loss "
            f"{float(m['total_loss']):.4f}, num_fg {float(m['num_fg']):.0f},"
            f" launches {train_launches}")
        del state, train_step, step
        torch.cuda.empty_cache()


ONESTAGE_MODELS = (("YOLOv5-s", "yolov5_s.yaml"),
                   ("YOLOv6-s", "yolov6_s.yaml"),
                   ("YOLOF R-50", "yolof/yolof_R_50_DC5_1x.yaml"))
ONESTAGE_EXTRA = (("YOLOv6-tiny", "yolov6/yolov6_tiny.yaml", {}),
                  ("YOLOv6-m", "yolov6/yolov6_m.yaml", {}),
                  ("YOLOV7 R-50 bifpn", "../wearmask/r50_bifpn.yaml",
                   {"meta_architecture": "YOLOV7"}),
                  ("YOLOV7 R-50 pan", "../wearmask/r50_pan.yaml",
                   {"meta_architecture": "YOLOV7"}))


def onestage_tail(out, cfg, nms=None):
    """The serving tail of ``cfg``'s architecture, with the NMS kernel
    unless ``nms`` is given: ``yolox_postprocess`` (YOLOV6),
    ``yolof_postprocess`` or :func:`anchor_tail`."""
    from yolov7_d2_tpu_torch.models.meta_arch.yolof import yolof_postprocess
    from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess

    kw = {} if nms is None else {"nms": nms}
    arch = cfg.meta_architecture
    with torch.inference_mode():
        if arch == "YOLOV6":
            return yolox_postprocess(out, cfg.conf_threshold,
                                     cfg.nms_threshold, cfg.max_detections,
                                     cfg.pre_nms_topk, **kw)
        if arch == "YOLOF":
            return yolof_postprocess(out, **kw)
    return anchor_tail(out, cfg, nms)


def onestage_serve(model, cfg, images):
    with torch.inference_mode():
        out = model(images)
    return out, onestage_tail(out, cfg)


def onestage_loss_keys(cfg) -> tuple:
    return {"YOLOV6": ("loss_iou", "loss_l1", "loss_obj", "loss_cls"),
            "YOLOF": ("loss_cls", "loss_box")}.get(
        cfg.meta_architecture, ("loss_box", "loss_obj", "loss_cls"))


def onestage_assignment(model, cfg, batch) -> dict:
    """What the loss of ``cfg``'s architecture assigns on ``model``'s
    train-mode outputs for ``batch``: SimOTA's foreground and matched gts
    (YOLOV6), the uniform matcher's winners and class map (YOLOF), the
    foreground count (YOLOV5: the ratio targets do not depend on the
    outputs)."""
    from yolov7_d2_tpu_torch.models.heads.yolox_head import (
        decode_outputs,
        simota_assign,
    )
    from yolov7_d2_tpu_torch.models.meta_arch import yolof as fm

    model.train()
    with torch.no_grad():
        out = model(batch["image"])
    model.eval()
    arch = cfg.meta_architecture
    with torch.no_grad():
        if arch == "YOLOV6":
            dec = decode_outputs(out["outputs"], out["grids"],
                                 out["strides"])
            a = simota_assign(*dec, out["grids"], out["strides"],
                              batch["gt_boxes"], batch["gt_classes"],
                              batch["gt_valid"])
            fg = a["fg_mask"]
            return {"fg_mask": fg,
                    "matched_gt": torch.where(fg, a["matched_gt"], -1)}
        if arch == "YOLOF":
            anchors = out["anchors"]
            pred = fm.decode_deltas(anchors[None], out["deltas"])
            m = fm.uniform_match(pred, anchors, batch["gt_boxes"],
                                 batch["gt_valid"],
                                 num_classes=cfg.num_classes)
            return {"winner": m["winner"],
                    "cls_map": fm.class_map(m, batch["gt_classes"],
                                            anchors.shape[0])}
    return {}


def onestage_phase(dev, card: str, gen: torch.Generator, kernels: dict,
                   requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                   small: int = 128, steps: int = FAMILY_STEPS,
                   big_batch: int = BATCH) -> None:
    """Section 15: the one-stage box detectors of ``configs/coco`` at the
    full width and depth of their yaml files, bf16 over f32 weights from
    ``SEED``: YOLOv5-s at 640 (``yolov5_s.yaml``), YOLOv6-s at 640
    (``yolov6_s.yaml``), YOLOF R-50 at 800 (``yolof/yolof_R_50_DC5_1x
    .yaml``). First the normalize kernel at YOLOF's mean and std on
    [``big_batch``, 800, 800, 3] against its plain version (the
    ``normalize_yolof`` entry). Then for each model (a) serving,
    ``build_model`` + the tail (``anchor_yolo_postprocess`` with the v5
    gate, ``yolox_postprocess``, ``yolof_postprocess``), for requests of 1,
    8 and 128 images (one normalize and one NMS launch a request; e2e,
    forward and tail by CUDA events, the device's busy share at the
    largest) and the kernel path's ``Detections`` equal to the plain
    path's (float input, plain NMS) at 8; (b) f32 outputs on the card
    against the CPU at ``small`` px within 1e-4 of the max, bf16 within
    5e-2; (c) ``steps`` steps of ``train_n`` images through
    ``build_system``, EMA on: YOLOv5 and YOLOv6 in ``make_packed_photo_
    step`` with mixup and GridMask (mode 1, prob 0.3), YOLOF on the uint8
    batch (the normalize kernel at its statistics); finite losses,
    foreground, parameters, EMA and BN statistics moved, FrozenBN
    statistics unmoved, ms a step, peak memory; (d) one f32 step at
    ``small`` px on the card against the CPU: the loss's assignments equal
    (SimOTA's foreground for YOLOv6, the winners and class map for YOLOF,
    the fg count), losses and grad norm within 1e-3. (e) one request and
    one train step each for ``yolov6_tiny.yaml`` (416), ``yolov6_m.yaml``
    and YOLOV7 on ResNet-50 with the ``bifpn`` and ``pan`` necks
    (``wearmask/r50_bifpn.yaml``, ``r50_pan.yaml`` under YOLOV7, which the
    necks need: the yaml's YOLOV7P keeps YOLOPAFPN). Each path's launches
    are counted from 0 and added to the normalize, normalize_yolof, NMS
    and GridMask entries."""
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import yolof as fm

    # ---- the normalize kernel at YOLOF's statistics, 800 px
    yolof_size = 800
    images = torch.randint(0, 256, (big_batch, yolof_size, yolof_size, 3),
                           generator=gen, dtype=torch.uint8).to(dev)
    args = (images, fm.PIXEL_MEAN, fm.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at YOLOF's mean and std")
    kernels["normalize_yolof"] = {
        "name": "normalize_yolof", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_yolof plain"),
        # no one PyTorch call takes uint8 NHWC to (x - mean) / std in
        # channels_last
        "library_ms": None,
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
        "launches": 0,
    }
    log(f"(15) normalize at YOLOF's mean {fm.PIXEL_MEAN} and std "
        f"{fm.PIXEL_STD}: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> bf16 channels_last")
    del images, got, want, args

    for name, yaml in ONESTAGE_MODELS:
        cfg = coco_cfg(yaml)
        size = cfg.input_size[0]
        is_yolof = cfg.meta_architecture == "YOLOF"
        norm_key = "normalize_yolof" if is_yolof else "normalize"
        # ---- (a) serving
        model = build_model(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"(15a) {name} {size} from {yaml}: {n_params / 1e6:.3f} M "
            f"parameters, {model.dtype}")
        batches = [letterboxed_batch(n, gen, size) for n in requests]
        torch.cuda.synchronize()
        build.reset_launches()
        for req in batches:
            _, dets = onestage_serve(model, cfg, req.to(dev))
            log(f"(15a) {name} request bs {req.shape[0]}: " +
                check_detections(dets, req.shape[0], cfg, name))
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        if launches.get("normalize", 0) != len(requests) or \
                launches.get("nms", 0) != len(requests):
            raise AssertionError(f"the {name} serving path launched "
                                 f"{launches}")
        kernels[norm_key]["launches"] += launches["normalize"]
        kernels["nms"]["launches"] += launches["nms"]
        log(f"(15a) {name} serving path launches, counted from 0: "
            f"{launches} ({'normalize_yolof' if is_yolof else 'normalize'}"
            " and nms a request)")
        for req in batches:
            n = req.shape[0]
            x = req.to(dev)
            e2e = cuda_ms(lambda: onestage_serve(model, cfg, x),
                          **request_timing(n))
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(x), **request_timing(n))
                head = model(x)
            tail = cuda_ms(lambda: onestage_tail(head, cfg))
            extra = ""
            if n == requests[-1]:
                busy, window = device_busy_ms(
                    lambda: onestage_serve(model, cfg, x))
                extra = (f"; device busy {busy:.3f} ms a call = "
                         f"{100 * busy / e2e:.1f}% of the untraced call "
                         f"(traced {window:.3f} ms)")
            log(f"{name} {size} bs {n} bf16 on [{card}]: e2e {e2e:.3f} ms "
                f"= {n * 1000 / e2e:.1f} img/s; forward-only {fwd:.3f} ms "
                f"= {n * 1000 / fwd:.1f} img/s; tail {tail:.3f} ms{extra}")
            del head, x
        x = batches[1].to(dev)
        _, dets = onestage_serve(model, cfg, x)
        with torch.inference_mode():
            plain = onestage_tail(model(x.float()), cfg,
                                  nms=nms_batched_plain)
        for f in ("boxes", "scores", "classes", "valid"):
            if not torch.equal(getattr(dets, f), getattr(plain, f)):
                raise AssertionError(f"{name}: the kernel path's {f} differ "
                                     "from the plain path's")
        log(f"(15a) {name} bs {x.shape[0]}: the kernel path's Detections "
            f"equal the plain path's index for index "
            f"({int(dets.valid.sum())} kept)")

        # ---- (b) f32 card against CPU, full width, small px
        f32 = dataclasses.replace(cfg, amp=False)
        one = letterboxed_batch(2, gen, small)
        with torch.inference_mode():
            ref = build_model(f32, "cpu", SEED)(one)
            on_card = build_model(f32, dev, SEED)(one.to(dev))
            bf16 = model(one.to(dev))
        gaps = []
        for k in (("logits", "deltas") if is_yolof else ("outputs",)):
            scale = float(ref[k].abs().max())
            err = float((on_card[k].cpu() - ref[k]).abs().max())
            err16 = float((bf16[k].float().cpu() - ref[k]).abs().max())
            gaps.append(f"{k} {err / scale:.3g} (bf16 {err16 / scale:.3g})")
            if err > 1e-4 * scale or err16 > 5e-2 * scale:
                raise AssertionError(f"{name} {k} on the card differs from "
                                     f"the CPU by {err} (bf16 {err16}) of "
                                     f"{scale}")
        log(f"(15b) {name} f32 forward at {small} px, card against CPU, "
            "error over each output's max: " + ", ".join(gaps))
        del model, batches, dets, plain, ref, on_card, bf16, x
        torch.cuda.empty_cache()

        # ---- (c) training through build_system
        tcfg = dataclasses.replace(cfg, ema=True, grid_mask=not is_yolof,
                                   grid_mask_mode=1, grid_mask_prob=0.3,
                                   mixup=True)
        _, state, train_step, fields = build_system(tcfg, device=dev,
                                                    seed=SEED)
        step = (train_step if is_yolof else
                make_packed_photo_step(tcfg, train_step, seed=SEED))
        frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
        tbatches = [{k: v.to(dev) for k, v in train_batch(
            train_n, gen, size).items()} for _ in range(4)]
        before = snapshot(state)
        metrics = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        warm = min(WARMUP, steps - 1)
        for i in range(steps):
            if i == warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, tbatches[i % 4])
            metrics.append(m)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
        launches = dict(build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        keys = onestage_loss_keys(cfg) + ("total_loss", "grad_norm")
        for i, m in enumerate(metrics):
            for key in keys:
                if not bool(torch.isfinite(m[key])):
                    raise AssertionError(f"{name} step {i}: {key} = "
                                         f"{float(m[key])}")
            if not float(m["num_fg"]) > 1.0:
                raise AssertionError(f"{name} step {i}: no foreground")
        after = snapshot(state)
        for key in before:
            if all(torch.equal(a, b) for a, b in zip(before[key],
                                                     after[key])):
                raise AssertionError(f"{name} training moved no {key} "
                                     "tensor")
        if is_yolof:
            if not frozen or not all(torch.equal(a, b) for a, b in zip(
                    frozen, frozen_bn_buffers(state.model))):
                raise AssertionError("YOLOF training moved FrozenBN "
                                     "statistics")
            if launches.get("normalize", 0) != steps:
                raise AssertionError(f"the YOLOF training path launched "
                                     f"{launches}")
            kernels["normalize_yolof"]["launches"] += launches["normalize"]
        else:
            if launches.get("grid_mask", 0) < 1:
                raise AssertionError(f"the {name} training path never "
                                     "launched grid_mask")
            kernels["grid_mask"]["launches"] += launches["grid_mask"]
        for i in (0, len(metrics) - 1):
            log(f"(15c) {name} train step {i}: " + ", ".join(
                f"{k} {float(metrics[i][k]):.4f}"
                for k in keys + ("num_fg",)))
        log(f"(15c) {name} {size} train step bs {train_n} bf16 on [{card}]: "
            f"{step_ms:.3f} ms a step = {train_n * 1000 / step_ms:.1f} img/s"
            f" (host clock over {steps - warm} steps after {warm}, batches "
            f"on the card, 100 slots, 1-100 boxes an image); peak memory "
            f"{peak_gb:.3f} GB; launches {launches}; parameters, EMA and BN "
            "statistics moved" + ("; FrozenBN statistics unmoved"
                                  if is_yolof else ""))
        del state, train_step, step, tbatches, metrics, before, after
        torch.cuda.empty_cache()

        # ---- (d) one f32 step, card against CPU, same weights and batch
        scfg = dataclasses.replace(cfg, input_size=(small, small),
                                   amp=False, warmup_iters=0)
        sbatch = train_batch(2, gen, small)
        sbatch["image"] = sbatch["image"].float()
        got, assigned = {}, {}
        for where in ("cpu", dev):
            b = {k: v.to(where) for k, v in sbatch.items()}
            assigned[str(where)] = onestage_assignment(
                build_model(scfg, where, SEED), scfg, b)
            _, st, ts, _ = build_system(scfg, device=where, seed=SEED)
            _, m = ts(st, b)
            got[str(where)] = {k: float(v) for k, v in m.items()}
        ref_m, card_m = got["cpu"], got[str(dev)]
        log(f"(15d) {name} f32 train step at {small} px, card vs CPU: "
            + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}"
                        for k in keys + ("num_fg",)))
        if card_m["num_fg"] != ref_m["num_fg"]:
            raise AssertionError(f"{name} fg count differs between the card "
                                 "and the CPU")
        for k, v in assigned["cpu"].items():
            if not torch.equal(assigned[str(dev)][k].cpu(), v):
                raise AssertionError(f"{name} assignment {k} differs "
                                     "between the card and the CPU")
        for k in keys:
            if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
                raise AssertionError(f"{name} {k} differs between the card "
                                     "and the CPU")
        log(f"(15d) {name}: assignments equal on the card and the CPU "
            f"({', '.join(assigned['cpu']) or 'the fg count'})")
        del st, ts
        torch.cuda.empty_cache()

    # ---- (e) the other configurations: one request, one train step
    for name, yaml, replace in ONESTAGE_EXTRA:
        ccfg = coco_cfg(yaml, **replace)
        size = ccfg.input_size[0]
        model = build_model(ccfg, dev, SEED)
        req = letterboxed_batch(requests[1], gen, size)
        build.reset_launches()
        _, dets = onestage_serve(model, ccfg, req.to(dev))
        torch.cuda.synchronize()
        serve_launches = dict(build.LAUNCHES)
        summary = check_detections(dets, req.shape[0], ccfg, name)
        del model
        ccfg = dataclasses.replace(ccfg, grid_mask=True, ema=True)
        _, state, train_step, _ = build_system(ccfg, device=dev, seed=SEED)
        step = make_packed_photo_step(ccfg, train_step, seed=SEED)
        tb = train_batch(train_n, gen, size)
        tb["gt_classes"] = tb["gt_classes"] % ccfg.num_classes
        build.reset_launches()
        state, m = step(state, {k: v.to(dev) for k, v in tb.items()})
        torch.cuda.synchronize()
        train_launches = dict(build.LAUNCHES)
        keys = onestage_loss_keys(ccfg) + ("total_loss", "grad_norm")
        if not all(bool(torch.isfinite(m[k])) for k in keys) or \
                not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"{name} train step: " + ", ".join(
                f"{k} {float(m[k])}" for k in keys + ("num_fg",)))
        for path, got_l, names in (("serving", serve_launches,
                                    ("normalize", "nms")),
                                   ("training", train_launches,
                                    ("grid_mask",))):
            for k in names:
                if got_l.get(k, 0) < 1:
                    raise AssertionError(f"{name} {path} never launched "
                                         f"{k}")
        for k in ("normalize", "nms"):
            kernels[k]["launches"] += serve_launches[k]
        kernels["grid_mask"]["launches"] += train_launches["grid_mask"]
        log(f"(15e) {name} {size} ({yaml}, {type(state.model.neck).__name__}"
            f"): bs {req.shape[0]} {summary}, launches {serve_launches}; one "
            f"train step of {train_n}: total loss "
            f"{float(m['total_loss']):.4f}, num_fg {float(m['num_fg']):.0f},"
            f" launches {train_launches}")
        del state, train_step, step
        torch.cuda.empty_cache()


@contextlib.contextmanager
def deterministic_library(sdpa_math: bool = False):
    """Within the block, cuDNN takes deterministic algorithms
    (``torch.backends.cudnn.deterministic``) and, with ``sdpa_math``,
    ``scaled_dot_product_attention`` its math backend: the library
    kernels that :func:`c14_phase` names."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cudnn.deterministic = True
    try:
        with (sdpa_kernel(SDPBackend.MATH) if sdpa_math
              else contextlib.nullcontext()):
            yield
    finally:
        torch.backends.cudnn.deterministic = False


def c14_families(dev, gen: torch.Generator, amp: bool = False) -> list:
    """Section 16's three training steps, each ``(name, build_fn, batch,
    sdpa)``: ``build_fn() -> (state, train_step)`` builds the step afresh
    with the weights of ``SEED``; ``sdpa`` says that it attends through
    ``scaled_dot_product_attention``. Float32, the bare step on 4 images:
    YOLOX-s 640 (section 10 (a)), SparseInst R-50 640 and DETR R-50 800 at
    dropout 0. With ``amp``, the bf16 recipe at its sections' batches
    (``tools/step_repeat.py`` times them): YOLOX-s 16 images with GridMask
    (``make_packed_photo_step``), SparseInst 16, DETR 8."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_system, build_yolox_system

    ycfg = dataclasses.replace(YoloxConfig(), amp=amp, grid_mask=amp)

    def yolox():
        _, state, step = build_yolox_system(ycfg, device=dev, seed=SEED)
        return state, (make_packed_photo_step(ycfg, step, seed=SEED) if amp
                       else step)

    def system(cfg):
        def build_fn():
            _, state, step, _ = build_system(cfg, device=dev, seed=SEED)
            return state, step
        return build_fn

    n = (16, 16, 8) if amp else (4, 4, 4)
    return [
        ("YOLOX-s 640", yolox,
         {k: v.to(dev) for k, v in train_batch(n[0], gen).items()}, False),
        ("SparseInst R-50 640", system(sparseinst_cfg(amp=amp)),
         inseg_batch(n[1], gen, dev), False),
        ("DETR R-50 800", system(detr_cfg(DETR_MODELS[0][1], amp=amp,
                                          dropout=0.0)),
         detr_batch(n[2], gen, dev), True)]


def c14_phase(dev, card: str) -> None:
    """Section 16 (ROADMAP.md C.14): is a training step on the card
    bitwise repeatable? For the bare float32 YOLOX-s 640 step of section 10
    (a) (4 images), SparseInst R-50 at 640 and DETR R-50 at 800 at dropout
    0 (4 images each), full depth and width, two runs of the step from the
    same weights and batch (:func:`repeat_phase`): logged, with the first
    gradient that differs and the module whose gradient the backward
    computed just before it. Then the same two runs with the library
    kernels named deterministic (cuDNN's algorithms; for DETR also
    ``scaled_dot_product_attention``'s math backend in place of its
    memory-efficient backward): every gradient and the weights after the
    step must be bitwise equal, which holds what the port owns (the
    bilinear resizes' fixed-order backward, ``sparseinst._resize``) and
    shows that what still parts the default runs is those library
    kernels."""
    gen = torch.Generator().manual_seed(SEED + 6)
    for what, build_fn, batch, sdpa in c14_families(dev, gen):
        repeat_phase(dev, card, f"{what} float32", build_fn, batch)
        with deterministic_library(sdpa):
            gaps = repeat_phase(
                dev, card, f"{what} float32, cuDNN deterministic"
                + (", SDPA math backend" if sdpa else ""), build_fn, batch)
        if gaps["outputs_differ"] or gaps["params_differ"] or \
                not gaps["weights_equal"]:
            raise AssertionError(f"C.14 {what}: two runs part with the "
                                 "library kernels deterministic, at "
                                 f"{gaps['output']}")
        del batch
        torch.cuda.empty_cache()


# the multi-GPU checks of SparseInst and DETR (section 17): name and the
# loss's global count
FAMILY_RANKS = (("SparseInst", "num_inst"), ("DETR", "num_boxes"))


def family_cfg(family: str, **replace):
    """SparseInst R-50 at 640 or DETR R-50 at 800 (dropout 0), full depth
    and width, fields replaced."""
    if family == "SparseInst":
        return sparseinst_cfg(**replace)
    return detr_cfg(DETR_MODELS[0][1], dropout=0.0, **replace)


def family_batch(family: str, n: int, gen: torch.Generator, size=None):
    """A training batch of ``n`` images on the CPU: SparseInst's masks at
    640 or DETR's boxes at 800."""
    if family == "SparseInst":
        return inseg_batch(n, gen, "cpu", size or SIZE)
    return detr_batch(n, gen, "cpu", size or DETR_SIZE)


def assignments_apart(a, b) -> int:
    """How many gts two ``(pred_of_gt, ok)`` assign apart."""
    return int(((a[1] != b[1]) | (a[1] & (a[0] != b[0]))).sum())


def family_plan(dev, family: str, world: int = 2, backend: str = "gloo",
                steps: int = 2, size=None):
    """The ranks' part of :func:`family_sync_phase`: its batches and rank
    call."""
    from yolov7_d2_tpu_torch.parallel.dryrun import train_steps

    kw = {} if size is None else {"input_size": (size, size)}
    cfg = family_cfg(family, amp=False, **kw)
    gen = torch.Generator().manual_seed(SEED + 7)
    batches = [family_batch(family, 2 * world, gen, size)
               for _ in range(steps)]
    out = os.path.join(REPO, "build", "chip_smoke_family_ranks", family)
    calls = [(train_steps, (
        out, cfg, batches, str(dev) if backend == "gloo" else dev.type,
        SEED, None, 1 if dev.type == "cuda" else None, False, True))]
    return types.SimpleNamespace(out=out, calls=calls, cfg=cfg,
                                 batches=batches, world=world, steps=steps)


def family_sync_phase(dev, card: str, family: str, world: int = 2,
                      backend: str = "gloo", steps: int = 2,
                      size=None, plan=None) -> None:
    """Section 17 (a), or (c) over NCCL: ``world`` ranks of ``family``'s
    bare float32 step (TF32 off, 2 images a rank, ``steps`` steps;
    ``parallel.dryrun.train_steps``: DDP, the global count in the loss)
    against the one-process step on the same images, each step from the
    ranks' weights and with the ranks' assignments (``batch["match"]``,
    their matches merged): the global count (SparseInst's ``num_inst``,
    DETR's ``num_boxes``) equal on every rank and in the one process, the
    summed loss shares and the gradient norm within 1e-3 relative, the
    ranks' weights bitwise equal. Logs how many assignments the one
    process's own matcher makes apart (its step under its own matcher,
    not held) and the CUDA kernels a rank's step launches. The ranks' part
    comes from ``plan`` (:func:`family_plan`, run by the caller's spawn),
    or is spawned here."""
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.parallel.dryrun import merge_matches
    from yolov7_d2_tpu_torch.utils.profiling import count_cuda_launches

    label = "(17a)" if backend == "gloo" else "(17c)"
    count = dict(FAMILY_RANKS)[family]
    if plan is None:
        plan = family_plan(dev, family, world, backend, steps, size)
        spawn_plans([plan], world, backend)
    cfg, batches, world, steps = plan.cfg, plan.batches, plan.world, \
        plan.steps
    ranks = [torch.load(os.path.join(plan.out, f"rank{r}.pt"),
                        weights_only=True) for r in range(world)]
    shutil.rmtree(plan.out, ignore_errors=True)

    _, state, step, _ = build_system(cfg, device=dev, seed=SEED)
    launches_one = None
    for i, batch in enumerate(batches):
        batch = {k: v.to(dev) for k, v in batch.items()}
        # DETR stacks its decoder levels: rows of levels x 2 images a rank
        levels = ranks[0]["matches"][i][0].shape[0] // 2
        merged = merge_matches([rec["matches"][i] for rec in ranks], levels)
        state.model.load_state_dict(ranks[0]["weights"][i])
        state.step = i
        _, m_own = step(state, batch)
        apart = assignments_apart(tuple(t.cpu() for t in state.match),
                                  merged)
        state.model.load_state_dict(ranks[0]["weights"][i])
        state.step = i
        batch["match"] = tuple(t.to(dev) for t in merged)
        if i == 1 and dev.type == "cuda":
            (state, m), launches_one = count_cuda_launches(
                lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        ms = [rec["metrics"][i] for rec in ranks]
        loss = sum(r["total_loss"] for r in ms)
        gaps = {"total_loss": relative_gap(loss, float(m["total_loss"])),
                "grad_norm": relative_gap(ms[0]["grad_norm"],
                                          float(m["grad_norm"]))}
        log(f"{label} {family} step {i}: {world} ranks / one process: "
            f"total_loss {loss:.6g} / {float(m['total_loss']):.6g} "
            f"({gaps['total_loss']:.2e}), grad_norm {ms[0]['grad_norm']:.6g}"
            f" / {float(m['grad_norm']):.6g} ({gaps['grad_norm']:.2e}), "
            f"{count} {ms[0][count]:.0f} / {float(m[count]):.0f}; auction "
            f"rounds by rank {[int(r['match_iters']) for r in ms]}; the one "
            f"process's own matcher makes {apart} of the ranks' "
            f"{int(merged[1].sum())} matches otherwise (its loss "
            f"{relative_gap(loss, float(m_own['total_loss'])):.2e} from the "
            "ranks', not held)")
        if any(r[count] != float(m[count]) for r in ms):
            raise AssertionError(f"{label} {family} step {i}: the global "
                                 f"{count} differs")
        if len({r["grad_norm"] for r in ms}) != 1:
            raise AssertionError(f"{label} {family} step {i}: the ranks' "
                                 "gradient norms differ")
        for key, gap in gaps.items():
            if gap > 1e-3:
                raise AssertionError(f"{label} {family} step {i}: {key} off "
                                     f"by {gap:.2e} relative, above 1e-3")
    for rec in ranks[1:]:
        for name, v in ranks[0]["model"].items():
            if not torch.equal(v, rec["model"][name]):
                raise AssertionError(f"{label} {family}: the ranks differ "
                                     f"in {name}")
    if any(rec["step"] != steps for rec in ranks):
        raise AssertionError(f"{label} {family}: the ranks took other than "
                             f"{steps} steps")
    where = ("on one card, host-paced over gloo and not a multi-GPU rate"
             if backend == "gloo" else "over NCCL, one card each")
    log(f"{label} {family} {world} {backend} ranks [{card}]: weights bitwise "
        f"equal across the ranks after {steps} steps; CUDA kernel launches "
        f"in step 1: one process {launches_one} ({2 * world} images), a "
        f"rank {ranks[0]['metrics'][1].get('launches')} (2 images, DDP); "
        f"{spawned(plan)}, {where}")
    del state, step
    torch.cuda.empty_cache()


def family_cli_data(family: str, images: int):
    """A synthetic mini-COCO (polygons for SparseInst) registered as the
    family's dataset: (work dir, dataset name, the CLI module, its
    yaml)."""
    from yolov7_d2_tpu_torch import train_inseg, train_transformer
    from yolov7_d2_tpu_torch.data.catalog import register_coco_instances

    name = f"chip_smoke_ranks_{family.lower()}"
    work = os.path.join(REPO, "build", name)
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=images,
                                  segm=family == "SparseInst")
    register_coco_instances(name, {}, js, img_dir)
    if family == "SparseInst":
        return work, name, train_inseg, SPARSEINST_YAML
    return work, name, train_transformer, os.path.join(
        DETR_DIR, DETR_MODELS[0][1])


def family_cli_args(yaml: str, out: str, name: str, *flags, **opts):
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    argv = ["--config-file", yaml, *flags, "OUTPUT_DIR", out,
            "DATASETS.TRAIN", f"('{name}',)", "DATASETS.TEST",
            f"('{name}',)", "SEED", str(SEED)]
    for k, v in opts.items():
        argv += [k.replace("__", "."), v if isinstance(v, str) else repr(v)]
    return default_argument_parser().parse_args(argv)


def family_cli_phase(dev, card: str, family: str, kernels: dict,
                     images: int = CLI_IMAGES, **opts) -> None:
    """Section 17 (b): ``train_inseg`` (the blend mosaic) or
    ``train_transformer`` (the crop branch) on a synthetic mini-COCO, 4
    steps of the section's batch (16 images at 640, or 8 at 800; one mapper
    thread), inside an NCCL group of 1 (DDP) and without a group: the
    losses at step 6 within
    1e-3 relative and both ms-a-step medians logged; ``train_inseg
    --eval-only`` in the group, on rank 0 (``COCOMaskEvaluator``'s keys).
    The group run's normalize launches are added to the family's entry of
    ``kernels``."""
    import torch.distributed as dist

    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.parallel.dist import init_distributed
    from yolov7_d2_tpu_torch.parallel.launch import local_dist_url

    steps = 4
    work, name, cli, yaml = family_cli_data(family, images)
    entry = ("normalize_sparseinst" if family == "SparseInst"
             else "normalize_detr")
    # one mapper thread: the mappers' threads share one generator, so that
    # with more the two runs would draw other augmentations
    opts = dict({"SOLVER.MAX_ITER": steps, "SOLVER.CHECKPOINT_PERIOD": steps,
                 "DATALOADER.NUM_WORKERS": 1,
                 "SOLVER.IMS_PER_BATCH": (TRAIN_BATCH if family ==
                                          "SparseInst" else DETR_TRAIN_BATCH),
                 **({"INPUT.MOSAIC.ENABLED": True} if family == "SparseInst"
                    else {"INPUT.CROP.ENABLED": True})}, **opts)
    runs = {}
    try:
        for group in (True, False):
            out = os.path.join(work, "group" if group else "plain")
            if group:
                init_distributed("nccl", local_dist_url(), 1, 0)
            try:
                torch.cuda.synchronize()
                build.reset_launches()
                t0 = time.perf_counter()
                trainer = cli.main(family_cli_args(yaml, out, name, **opts))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(build.LAUNCHES)
                if (trainer.state.ddp is not None) != group:
                    raise AssertionError(f"(17b) {family}: DDP built where "
                                         "it should not, or not where it "
                                         "should")
                if group:
                    if launches.get("normalize", 0) != steps:
                        raise AssertionError(f"(17b) {family} launches "
                                             f"{launches}")
                    kernels[entry]["launches"] += launches["normalize"]
                    if family == "SparseInst":
                        t1 = time.perf_counter()
                        results = cli.main(family_cli_args(
                            yaml, out, name, "--eval-only", **opts))
                        eval_s = time.perf_counter() - t1
                        if "AP" not in results or "AR100" not in results:
                            raise AssertionError(f"(17b) train_inseg "
                                                 f"--eval-only: {results}")
                        log(f"(17b) train_inseg --eval-only in the NCCL "
                            f"group of 1, rank 0: {images} images in "
                            f"{eval_s:.2f} s, AP {results['AP']:.4f}")
            finally:
                if group:
                    dist.destroy_process_group()
            latest = trainer.storage.latest()
            if not all(math.isfinite(latest[k]) for k in latest):
                raise AssertionError(f"(17b) {family}: {latest}")
            runs[group] = (latest, trainer.storage.median("time_per_iter"),
                           wall, launches)
            del trainer
            torch.cuda.empty_cache()
    finally:
        DatasetCatalog.remove(name)
        shutil.rmtree(work, ignore_errors=True)
    (d, md, wd, ld), (p, mp, wp, _) = runs[True], runs[False]
    keys = [k for k in d if "loss" in k and not k.startswith("aux")]
    log(f"(17b) {cli.__name__.rsplit('.', 1)[-1]} step {steps}, NCCL world "
        "1 / no group: " + ", ".join(f"{k} {d[k]:.6g} / {p[k]:.6g}"
                                     for k in keys)
        + f"; launches in the group {ld}")
    for k in keys:
        if relative_gap(d[k], p[k]) > 1e-3:
            raise AssertionError(f"(17b) {family}: {k} differs from the run "
                                 "without a group")
    log(f"(17b) {family} CLI on [{card}], {opts['SOLVER.IMS_PER_BATCH']} "
        f"images a step: time_per_iter median {md * 1e3:.3f} ms in an NCCL "
        f"group of 1 (DDP) against {mp * 1e3:.3f} ms without a group: ratio "
        f"{md / mp:.4f}; {steps} steps in {wd:.2f} s and {wp:.2f} s (builds "
        "included)")


def family_nccl_phase(dev, card: str, family: str,
                      images: int = CLI_IMAGES, size=None, **opts) -> None:
    """Section 17 (c): where two or more cards are visible, N of them (up to
    4) over NCCL, one a rank: :func:`family_sync_phase`'s bare step against
    one process, then ``--num-gpus N`` through the family's CLI, the
    section's batch a rank, 6 steps; rank 0's metrics.json (one line, the
    global count) and checkpoint checked (``size`` and ``opts``, config
    keys with ``__`` for ``.``, override the section's). Logged as skipped
    on one card."""
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        log(f"(17c) {family} on NCCL ranks: skipped, {n} CUDA card visible "
            "(needs 2)")
        return
    family_sync_phase(dev, card, family, world=n, backend="nccl", size=size)
    work, name, cli, yaml = family_cli_data(family, images)
    count = dict(FAMILY_RANKS)[family]
    per_rank = TRAIN_BATCH if family == "SparseInst" else DETR_TRAIN_BATCH
    out = os.path.join(work, "nccl")
    try:
        t0 = time.perf_counter()
        cli.main(family_cli_args(
            yaml, out, name, "--num-gpus", str(n), **dict(dict(
                SOLVER__MAX_ITER=6, SOLVER__CHECKPOINT_PERIOD=6,
                SOLVER__IMS_PER_BATCH=n * per_rank), **opts)))
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.json")) as f:
            lines = [json.loads(line) for line in f]
        last = lines[-1]
        if [r["iteration"] for r in lines] != [6] or not math.isfinite(
                last["total_loss"]) or not last[count] >= 1:
            raise AssertionError(f"(17c) {family}: rank 0's metrics.json: "
                                 f"{lines}")
        if Checkpointer(os.path.join(out, "ckpt")).steps() != [6]:
            raise AssertionError(f"(17c) {family}: no checkpoint at step 6")
    finally:
        DatasetCatalog.remove(name)
        shutil.rmtree(work, ignore_errors=True)
    log(f"(17c) {family} {n} NCCL ranks on [{card}] x{n}: the CLI, 6 steps "
        f"of {per_rank} images a rank in {wall:.2f} s (start-up included); "
        f"step 6: total_loss {last['total_loss']:.6g}, {count} "
        f"{last[count]:.0f} (global), time_per_iter "
        f"{last['time_per_iter'] * 1e3:.3f} ms on rank 0")


# ---------------------------------------------------------------------------
# section 19: the backbone zoo and the other DETR variants
# ---------------------------------------------------------------------------

ZOO_DATASET = "chip_smoke_mini_coco_zoo"
ZOO_YOLOX_YAML = "yolox/yolox_convnext.yaml"  # under configs/coco; 800 px
ZOO_SMCA_YAML = "smca_detr_r50.yaml"  # under configs/coco/detr; 800 px
ZOO_YOLOX_OTHERS = ("yolox_regnetx_s.yaml", "yolox_convnext.yaml")
ZOO_ANCHOR_OTHERS = (
    ("YOLOV7 regnetx_0.4g.yaml", "regnetx_0.4g.yaml", {}),
    ("YOLOV7 canaries/regnetx_0.2g.yaml", "../canaries/regnetx_0.2g.yaml",
     {}))
# wearmask/efficient_b2.yaml taps b0's block indices on b2, at strides 4,
# 16 and 16, which YOLOFPN cannot join in either package (ROADMAP.md C.31):
# it runs with the taps at b2's stage ends
EFFICIENT_B2_TAPS = (4, 7, 15, 22)
ZOO_DETR_OTHERS = ("smcadetr_origin.yaml", "d2go/smca_bs16.yaml",
                   "d2go/smca_bs64.yaml", "d2go/smca_regnetx_0.4g.yaml",
                   "dab_detr_r50.yaml", "d2go/detr_bs16.yaml",
                   "d2go/detr_fbv3_bs16.yaml", "d2go/smca_fbv3.yaml")


def check_yolox_metrics(metrics, what: str) -> None:
    for i, m in enumerate(metrics):
        for key in ("loss_iou", "loss_obj", "loss_cls", "total_loss",
                    "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"{what} step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"{what} step {i}: no foreground anchor")


def drop_path_share(dev, card: str, gen: torch.Generator, cfg,
                    train_n: int, steps: int, size: int) -> None:
    """(19a) ConvNeXt's drop path on the card, in the training step of
    ``build_yolox_system``: ``steps`` float32 steps of ``train_n`` images
    at ``size`` px, the masks drawn from the model's CUDA generator,
    reseeded by the step. A hook on the last block (rate
    ``DROP_PATH_RATE``) reads which samples kept their branch (a dropped
    one leaves the block's input as it is; in float32 a kept one moves it,
    layer scale 1e-6 and all), and the kept share must lie within 3
    standard deviations of 1 - rate."""
    from yolov7_d2_tpu_torch.engine import build_yolox_system

    f32 = dataclasses.replace(cfg, amp=False, input_size=(size, size),
                              warmup_iters=0)
    _, state, step = build_yolox_system(f32, device=dev, seed=SEED)
    block = state.model.backbone.stages[-1][-1]
    if block.drop_path != cfg.zoo.convnext_drop_path_rate:
        raise AssertionError(f"the last block's drop path is "
                             f"{block.drop_path}")
    kept = []
    handle = block.register_forward_hook(lambda mod, args, out: kept.append(
        (out - args[0]).flatten(1).abs().amax(1) > 0))
    try:
        for i in range(steps):
            state, m = step(state, {k: v.to(dev) for k, v in train_batch(
                train_n, gen, size).items()})
            check_yolox_metrics([m], f"drop path step {i}")
    finally:
        handle.remove()
    kept = torch.cat(kept).float()
    p = 1.0 - block.drop_path
    sigma = math.sqrt(p * (1.0 - p) / kept.numel())
    share = float(kept.mean())
    log(f"(19a) ConvNeXt drop path on [{card}]: the last block (rate "
        f"{block.drop_path}) kept {int(kept.sum())} of {kept.numel()} "
        f"samples over {steps} float32 steps of {train_n} at {size} px = "
        f"{share:.4f}, expected {p:.4f} +- {3 * sigma:.4f} (3 sigma)")
    if abs(share - p) > 3 * sigma:
        raise AssertionError("the drop path's kept share is off its rate")


def zoo_kernel_entries(dev, gen: torch.Generator, kernels: dict,
                       images: torch.Tensor, train_n: int) -> None:
    """(19a) The normalize kernel in its identity form on ``images`` (the
    largest YOLOX ConvNeXt-T request, uint8 [128, 800, 800, 3] -> bf16
    channels_last) and the GridMask kernel on float32 [``train_n``, 800,
    800, 3] with drawn parameters, each bit-exact against its plain
    version: the ``normalize_800`` and ``grid_mask_800`` entries of
    ``kernels``, whose launches are those of YOLOX on ConvNeXt-T at 800."""
    from yolov7_d2_tpu_torch.kernels.grid_mask import (
        grid_mask,
        grid_mask_plain,
    )
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )

    size = images.shape[1]
    args = (images, (0.0,) * 3, (1.0,) * 3, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError(f"normalize kernel differs from its plain "
                             f"version in its identity form at {size} px")
    kernels["normalize_800"] = {
        "name": "normalize_800", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_800 plain"),
        # the identity case as one PyTorch call: cast into channels_last
        "library_ms": kernel_ms(lambda: images.permute(0, 3, 1, 2).to(
            torch.bfloat16, memory_format=torch.channels_last),
            host_ok="normalize_800 library"),
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
        "launches": 0,
    }
    del got, want
    gparams, _, f32 = grid_mask_inputs(dev, gen, size)
    got, want = grid_mask(f32, gparams), grid_mask_plain(f32, gparams)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"GridMask kernel differs from its plain "
                             f"version on float32 at {size} px")
    kernels["grid_mask_800"] = {
        "name": "grid_mask_800", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/grid_mask.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:83",
        "max_abs_err": float((got - want).abs().max()),
        "ms": kernel_ms(lambda: grid_mask(f32, gparams)),
        "plain_ms": kernel_ms(lambda: grid_mask_plain(f32, gparams),
                              host_ok="grid_mask_800 plain"),
        "library_ms": None,  # no single PyTorch call computes GridMask
        # read once, written once; one select an element
        **bound(f32.numel() * 4 * 2, f32.numel()),
        "launches": 0,
    }
    zeroed = [round(float(z), 3)
              for z in (got == 0).all(-1).flatten(1).float().mean(1)]
    log(f"(19a) normalize (identity, bf16) on {tuple(images.shape)} and "
        f"grid_mask on {tuple(f32.shape)} float32: bit-exact against their "
        f"plain versions; share zeroed an image {zeroed}")
    del got, want, f32, gparams
    torch.cuda.empty_cache()


def yolox_zoo_paths(dev, card: str, gen: torch.Generator, kernels: dict,
                    requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                    small: int = 128, steps: int = FAMILY_STEPS,
                    drop_px: int = 256) -> None:
    """(19a) YOLOX on ConvNeXt-T (``configs/coco/yolox/yolox_convnext.yaml``,
    800 px, YOLOPAFPN and the head at 0.33 / 0.50 on ConvNeXt's 192 / 384 /
    768 channels, drop path 0.2, bf16 over f32 weights from ``SEED``):
    the kernels at its shapes (:func:`zoo_kernel_entries`); ``Predictor``
    serving at each request size (normalize kernel in its
    identity form, NMS kernel; launches counted from 0), the kernel path's
    ``Detections`` equal to the plain NMS path's at the largest, the f32
    head outputs on the card against the CPU at ``small`` px within 1e-4
    of the max (bf16 within 5e-2), times by CUDA events and the device's
    busy share at the largest; ``steps`` training steps of ``train_n``
    images in ``make_packed_photo_step`` with GridMask and mixup on; one
    float32 step at ``small`` px and drop path 0 on the card against the
    CPU (their generators draw other masks); the drop path's kept share
    (:func:`drop_path_share`)."""
    from yolov7_d2_tpu_torch.data.device_aug import (
        DevicePhotometric,
        PhotoDraws,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.predictor import Predictor

    cfg = coco_cfg(ZOO_YOLOX_YAML)
    size = cfg.input_size[0]
    name = "YOLOX ConvNeXt-T"
    predictor = Predictor(cfg, device=dev, seed=SEED)
    model = predictor.model
    log(f"(19a) {name} {size} from configs/coco/{ZOO_YOLOX_YAML}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters, {model.dtype}, neck on "
        f"{list(model.backbone.out_channels.values())} channels, drop path "
        f"{cfg.zoo.convnext_drop_path_rate}")
    batches = [letterboxed_batch(n, gen, size) for n in requests]
    big = batches[-1].to(dev)
    zoo_kernel_entries(dev, gen, kernels, big, train_n)
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        dets = predictor.predict_batch(req.to(dev))
        log(f"(19a) {name} request bs {req.shape[0]}: "
            + check_detections(dets, req.shape[0], cfg, f"{name} serving"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for kernel, key in (("normalize", "normalize_800"), ("nms", "nms")):
        if launches.get(kernel, 0) != len(requests):
            raise AssertionError(f"the {name} serving path launched "
                                 f"{kernel} {launches.get(kernel, 0)} times")
        kernels[key]["launches"] += launches[kernel]
    head = predictor.forward(big)
    with_kernel = predictor.postprocess(head)
    with_plain = predictor.postprocess(head, nms=nms_batched_plain)
    for field in ("valid", "classes", "boxes", "scores"):
        if not torch.equal(getattr(with_kernel, field),
                           getattr(with_plain, field)):
            raise AssertionError(f"{name} bs {big.shape[0]}: Detections."
                                 f"{field} of the kernel path differ from "
                                 "the plain path")
    log(f"(19a) {name} bs {big.shape[0]}: kernel-path Detections equal the "
        f"plain-path ones ({int(with_kernel.valid.sum())} kept)")
    del head, with_kernel, with_plain

    f32 = dataclasses.replace(cfg, amp=False, input_size=(small, small))
    one = letterboxed_batch(2, gen, small)
    ref = Predictor(f32, device="cpu", seed=SEED).forward(one)["outputs"]
    on_card = Predictor(f32, device=dev, seed=SEED).forward(one)[
        "outputs"].cpu()
    bf16 = predictor.forward(one)["outputs"].float().cpu()
    scale = float(ref.abs().max())
    err32 = float((on_card - ref).abs().max())
    err16 = float((bf16 - ref).abs().max())
    log(f"(19a) {name} head outputs at {small} px vs float32 on the CPU (max "
        f"|ref| {scale:.4g}): float32 card {err32 / scale:.3g} of the max, "
        f"bf16 {err16 / scale:.3g} on [{card}]")
    if err32 > 1e-4 * scale or err16 > 5e-2 * scale:
        raise AssertionError(f"{name} head outputs disagree with the CPU")

    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: predictor.predict_batch(x),
                      **request_timing(n))
        fwd = cuda_ms(lambda: predictor.forward(x), **request_timing(n))
        head = predictor.forward(x)
        tail = cuda_ms(lambda: predictor.postprocess(head))
        extra = ""
        if n == requests[-1]:
            busy, window = device_busy_ms(lambda: predictor.predict_batch(x))
            extra = (f"; device busy {busy:.3f} ms a call = "
                     f"{100 * busy / e2e:.1f}% of the untraced call "
                     f"(traced {window:.3f} ms)")
        log(f"{name} {size} bs {n} bf16 on [{card}]: e2e {e2e:.3f} ms = "
            f"{n * 1000 / e2e:.1f} img/s; forward-only {fwd:.3f} ms = "
            f"{n * 1000 / fwd:.1f} img/s; tail {tail:.3f} ms{extra}")
    del predictor, model, batches, big, head, x
    torch.cuda.empty_cache()

    # training: mixup and GridMask on, EMA on, drop path from the step
    tcfg = dataclasses.replace(cfg, grid_mask=True)
    _, state, train_step = build_yolox_system(tcfg, device=dev, seed=SEED)
    step = make_packed_photo_step(tcfg, train_step, seed=SEED)
    tbatches = [{k: v.to(dev) for k, v in train_batch(
        train_n, gen, size).items()} for _ in range(4)]
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    warm = min(WARMUP, steps - 1)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, tbatches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches.get("grid_mask", 0) < 1:
        raise AssertionError(f"the {name} training path never launched "
                             "grid_mask")
    kernels["grid_mask_800"]["launches"] += launches["grid_mask"]
    check_yolox_metrics(metrics, f"{name} train")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"{name} training moved no {key} tensor")
    fmt = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "num_fg",
           "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"(19a) {name} train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    log(f"(19a) {name} {size} train step bs {train_n} bf16 on [{card}]: "
        f"{step_ms:.3f} ms a step = {train_n * 1000 / step_ms:.1f} img/s "
        f"(host clock over {steps - warm} steps after {warm}, batches on the "
        f"card); peak memory {peak_gb:.3f} GB; launches {launches}; "
        f"{sum(m['grid_masked'] for m in metrics)} of "
        f"{train_n * len(metrics)} images GridMask-ed; parameters, EMA and "
        "BN statistics moved")
    del state, train_step, step, tbatches, before, after, metrics
    torch.cuda.empty_cache()

    # one f32 step, card against CPU, from the same weights, batch and
    # draws; drop path 0, since the two generators draw other masks
    scfg = dataclasses.replace(
        tcfg, zoo=dataclasses.replace(cfg.zoo, convnext_drop_path_rate=0.0),
        input_size=(small, small), amp=False, warmup_iters=0)
    sbatch = train_batch(2, gen, small)
    draws = PhotoDraws(
        perm=torch.tensor([1, 0]), do_mix=torch.tensor([True, False]),
        grid_params=torch.tensor([[16, 8, 3, 5, 1], [12, 6, 2, 7, 0]],
                                 dtype=torch.int32),
        do_flip=torch.tensor([False, True]))
    got = {}
    for where in ("cpu", dev):
        _, st, ts = build_yolox_system(scfg, device=where, seed=SEED)
        b = DevicePhotometric(scfg).apply(
            {k: v.to(where) for k, v in sbatch.items()}, draws)
        _, m = ts(st, b)
        got[str(where)] = {k: float(v) for k, v in m.items()}
    ref_m, card_m = got["cpu"], got[str(dev)]
    log(f"(19a) {name} float32 train step at {small} px, card vs CPU: "
        + ", ".join(f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError(f"{name} fg count differs between card and CPU")
    for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "grad_norm"):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"{name} {k} differs between the card and "
                                 "the CPU")
    del st, ts
    torch.cuda.empty_cache()
    drop_path_share(dev, card, gen, cfg, train_n, WARMUP + ITERS, drop_px)


def zoo_train_det_run(dev, card: str, kernels: dict,
                      train_n: int = TRAIN_BATCH,
                      cli_images: int = CLI_IMAGES, steps: int = 4,
                      **cli_opts) -> None:
    """(19a) ``train_det`` on ``configs/coco/yolox/yolox_convnext.yaml`` and
    a synthetic mini-COCO of ``cli_images`` JPEGs: ``steps`` steps on the
    host mosaic feed, checkpoints at half and at the end, the COCO eval at
    the end (normalize and NMS kernels, their launches added to
    ``kernels``); finite losses, weights and EMA moved (``cli_opts``
    override config keys, ``__`` for ``.``)."""
    from yolov7_d2_tpu_torch import train_det
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    work = os.path.join(REPO, "build", "chip_smoke_zoo")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=cli_images)
    register_coco_instances(ZOO_DATASET, {}, js, img_dir)
    out = os.path.join(work, "out")
    opts = dict(DATASETS__TRAIN=(ZOO_DATASET,), DATASETS__TEST=(ZOO_DATASET,),
                SOLVER__IMS_PER_BATCH=train_n, SOLVER__MAX_ITER=steps,
                SOLVER__CHECKPOINT_PERIOD=steps // 2,
                TEST__EVAL_PERIOD=steps, **cli_opts)
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_det.main(default_argument_parser().parse_args(
            cli_argv(out, config=ZOO_YOLOX_YAML, **opts)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        latest = cli_checks(trainer, out, "train_det ConvNeXt-T")
        for kernel, key in (("normalize", "normalize_800"), ("nms", "nms")):
            if launches.get(kernel, 0) < 1:
                raise AssertionError(f"train_det ConvNeXt-T never launched "
                                     f"{kernel}")
            kernels[key]["launches"] += launches[kernel]
        evals = {k: round(v, 4) for k, v in latest.items()
                 if k.startswith("eval/")}
        log(f"(19a) train_det {ZOO_YOLOX_YAML} on [{card}], {train_n} images "
            f"a step: {steps} steps and the COCO eval in {wall:.2f} s (build "
            f"included); total_loss {latest['total_loss']:.4f}, "
            f"time_per_iter median "
            f"{trainer.storage.median('time_per_iter') * 1e3:.3f} ms; eval "
            f"{evals}; launches {launches}")
        del trainer
    finally:
        DatasetCatalog.remove(ZOO_DATASET)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def zoo_yolox_others(dev, gen: torch.Generator, kernels: dict, bs: int = 8,
                     train_n: int = TRAIN_BATCH) -> None:
    """(19c) One ``Predictor`` request of ``bs`` images and one step of
    ``build_yolox_system`` in ``make_packed_photo_step`` (GridMask on) of
    ``train_n`` images each of ``ZOO_YOLOX_OTHERS`` at its size, one model
    built for both; launches counted from 0 and added to ``kernels``."""
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.predictor import Predictor

    for yaml in ZOO_YOLOX_OTHERS:
        cfg = coco_cfg(yaml, grid_mask=True)
        size = cfg.input_size[0]
        model, state, train_step = build_yolox_system(cfg, device=dev,
                                                      seed=SEED)
        predictor = Predictor(cfg, device=dev, model=model.eval())
        req = letterboxed_batch(bs, gen, size).to(dev)
        build.reset_launches()
        summary = check_detections(predictor.predict_batch(req), bs, cfg,
                                   yaml)
        torch.cuda.synchronize()
        serve = dict(build.LAUNCHES)
        del predictor
        step = make_packed_photo_step(cfg, train_step, seed=SEED)
        build.reset_launches()
        state, m = step(state, {k: v.to(dev) for k, v in train_batch(
            train_n, gen, size).items()})
        torch.cuda.synchronize()
        train = dict(build.LAUNCHES)
        check_yolox_metrics([m], yaml)
        for path, got_l, names in (("serving", serve, ("normalize", "nms")),
                                   ("training", train, ("grid_mask",))):
            for kernel in names:
                if got_l.get(kernel, 0) < 1:
                    raise AssertionError(f"{yaml} {path} never launched "
                                         f"{kernel}")
                kernels[kernel]["launches"] += got_l[kernel]
        log(f"(19c) YOLOX {yaml} ({cfg.backbone}) at {size}: bs {bs} "
            f"{summary}, launches {serve}; one train step of {train_n}: "
            f"total loss {float(m['total_loss']):.4f}, num_fg "
            f"{float(m['num_fg']):.0f}, launches {train}")
        del model, state, train_step, step
        torch.cuda.empty_cache()


def zoo_detr_others(dev, gen: torch.Generator, kernels: dict, bs: int = 8,
                    train_n: int = DETR_TRAIN_BATCH, size: int = DETR_SIZE
                    ) -> None:
    """(19c) One request of ``bs`` images (the family's tail, ``detr_tail``)
    and one ``build_system`` step of ``train_n`` images each of
    ``ZOO_DETR_OTHERS`` at ``size``, one model built for both: finite
    losses, every level's matched count the valid gts; the normalize
    launches (one a request, one a step) added to ``kernels``'s
    ``normalize_detr`` entry."""
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build

    for yaml in ZOO_DETR_OTHERS:
        cfg = detr_cfg(yaml, input_size=(size, size))
        model, state, train_step, _ = build_system(cfg, device=dev,
                                                   seed=SEED)
        req = letterboxed_batch(bs, gen, size).to(dev)
        build.reset_launches()
        _, dets = detr_serve(model.eval(), cfg, req)
        summary = check_detections(dets, bs, cfg, yaml)
        torch.cuda.synchronize()
        serve = dict(build.LAUNCHES)
        what = (f"{type(model).__name__} on {type(model.backbone).__name__}"
                f", {model.class_embed.out_features} logits")
        batch = detr_batch(train_n, gen, dev, size)
        build.reset_launches()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        train = dict(build.LAUNCHES)
        for key in ("total_loss", "loss_ce", "loss_bbox", "loss_giou",
                    "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"{yaml}: {key} = {float(m[key])}")
        if int(m["num_matched"]) != int(batch["gt_valid"].sum()):
            raise AssertionError(f"{yaml}: matched {int(m['num_matched'])}")
        for path, got_l in (("serving", serve), ("training", train)):
            if got_l.get("normalize", 0) != 1:
                raise AssertionError(f"{yaml} {path} launches {got_l}")
            kernels["normalize_detr"]["launches"] += 1
        log(f"(19c) {yaml} ({what}) at {size}: bs {bs} {summary}; one "
            f"train step of {train_n} ({cfg.optimizer}"
            + (f", clip {cfg.clip_type} {cfg.clip_value}"
               if cfg.clip_gradients else "")
            + f"): total loss {float(m['total_loss']):.4f}, matched "
            f"{int(m['num_matched'])}, launches {serve} / {train}")
        del model, state, train_step, batch
        torch.cuda.empty_cache()


def zoo_phase(dev, card: str, gen: torch.Generator, kernels: dict,
              requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
              detr_train_n: int = DETR_TRAIN_BATCH, small: int = 128,
              steps: int = FAMILY_STEPS, cli_images: int = CLI_IMAGES,
              cli_steps: int = 4, drop_px: int = 256,
              detr_size: int = DETR_SIZE, **cli_opts) -> None:
    """Section 19: the backbone zoo (RegNet, ConvNeXt, EfficientNet, FBNet)
    and the other DETR variants (SMCA-DETR, DAB-DETR, the d2go DETR), full
    depth and width, bf16 over f32 weights from ``SEED``. (a) YOLOX on
    ConvNeXt-T at 800 (:func:`yolox_zoo_paths`) and ``train_det`` on it
    (:func:`zoo_train_det_run`); (b) SMCA-DETR R-50 at 800
    (``configs/coco/detr/smca_detr_r50.yaml``) through
    :func:`detr_model_paths` (serving at each request size, card against
    CPU, ``steps`` steps of ``detr_train_n``, one f32 step against the
    CPU) and ``train_transformer`` for ``cli_steps`` steps; (c) one request
    and one step each of the other yamls the slice unlocks: YOLOX on
    RegNetX-400MF and ConvNeXt-T at 640, YOLOV7 on RegNetX-400MF, -200MF
    and EfficientNet-b2 (taps ``EFFICIENT_B2_TAPS``), and the DETR variants
    of ``ZOO_DETR_OTHERS``. Each path's launches are counted from 0 and
    added to ``kernels``. Logs the section's seconds."""
    t0 = time.perf_counter()
    yolox_zoo_paths(dev, card, gen, kernels, requests, train_n, small,
                    steps, drop_px)
    zoo_train_det_run(dev, card, kernels, train_n, cli_images, cli_steps,
                      **cli_opts)
    batches = [letterboxed_batch(n, gen, detr_size) for n in requests]
    detr_model_paths(dev, card, gen, kernels, "SMCA-DETR", ZOO_SMCA_YAML,
                     "19b", batches, detr_train_n, detr_size, small, steps)
    del batches
    detr_cli_run(dev, card, kernels, "19b", "SMCA-DETR", ZOO_SMCA_YAML,
                 detr_train_n, detr_size, cli_images, cli_steps,
                 resume=False, **cli_opts)
    zoo_yolox_others(dev, gen, kernels, requests[1], train_n)
    b2 = coco_cfg("../wearmask/efficient_b2.yaml").zoo
    anchor_others_phase(dev, gen, ZOO_ANCHOR_OTHERS + ((
        "YOLOV7 wearmask/efficient_b2.yaml", "../wearmask/efficient_b2.yaml",
        {"zoo": dataclasses.replace(
            b2, efficientnet_feature_indices=EFFICIENT_B2_TAPS)}),), "19",
        requests[1], train_n, kernels)
    zoo_detr_others(dev, gen, kernels, requests[1], detr_train_n, detr_size)
    log(f"(19) section 19 in {time.perf_counter() - t0:.1f} s on [{card}]")


# ---------------------------------------------------------------------------
# section 20: deformable convolution and the last mask families
# ---------------------------------------------------------------------------

DCN_YAML = "sparseinst/sparse_inst_r50_dcn_giam_aug.yaml"  # configs/coco
DCN_OTHERS = ("sparseinst/sparse_inst_r50vd_dcn_giam.yaml",
              "sparseinst/sparse_inst_r50vd_dcn_giam_aug.yaml")
SOLOV2_YAML = "solov2/solov2_r50.yaml"
SOLOV2_LITE_YAML = "../coco-instance/solov2_lite.yaml"
DLA_YAML = "dla34_yolox.yaml"
YOLOMASK_YAMLS = ("../coco-instance/yolomask.yaml",
                  "../coco-instance/yolomask_8gpu.yaml",
                  "../canaries/yolomask_2gpu.yaml",
                  "../canaries/yolomask_m_8gpu.yaml")
DETR_SEGM_YAML = "detr_256_6_6_torchvision_mask.yaml"  # configs/coco/detr
MASK_STEPS = 6  # the (a) and (b) steps of 16: 3 warm-up, 3 timed


def mask_batch(n: int, gen: torch.Generator, dev, size: int = SIZE,
               slots: int = 100, max_inst: int = 20) -> dict:
    """:func:`inseg_batch` with each mask's box (``gt_boxes``, xyxy
    pixels, ``solov2.mask_boxes``): the batch of SOLOv2 and YOLOMask."""
    from yolov7_d2_tpu_torch.models.meta_arch.solov2 import mask_boxes

    batch = inseg_batch(n, gen, dev, size, slots, max_inst)
    batch["gt_boxes"] = mask_boxes(batch["gt_masks"].bool(),
                                   plus_one=True)[0]
    return batch


def solov2_serve(model, cfg, images, **tail):
    """uint8 batch -> the normalize kernel and the model ->
    ``solov2_postprocess`` (the JAX defaults unless ``tail`` says)."""
    from yolov7_d2_tpu_torch.models.meta_arch.solov2 import (
        solov2_postprocess,
    )

    with torch.inference_mode():
        out = model(images)
        return out, solov2_postprocess(out, **tail)


def check_mask_detections(dets, n: int, hm: int, what: str,
                          need: bool = True) -> str:
    """Masks [n, 100, hm, hm] and boxes, finite; with ``need``, an
    instance in every image."""
    if dets.masks.shape != (n, 100, hm, hm) or dets.boxes.shape != (n, 100,
                                                                   4):
        raise AssertionError(f"{what}: Detections shapes "
                             f"{tuple(dets.masks.shape)}")
    counts = dets.num_valid()
    if need and int(counts.min()) < 1:
        raise AssertionError(f"{what}: an image with no instance")
    if not torch.isfinite(dets.scores).all() or \
            not torch.isfinite(dets.masks).all():
        raise AssertionError(f"{what}: non-finite scores or masks")
    return f"instances per image {int(counts.min())}-{int(counts.max())}"


def equal_detections(a, b, what: str, fields=("valid", "classes", "boxes",
                                              "scores", "masks")) -> None:
    for field in fields:
        x, y = getattr(a, field), getattr(b, field)
        if x is None and y is None:
            continue
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: Detections.{field} of the kernel "
                                 "path differ from the plain path")


def serving_times(card: str, name: str, size: int, batches, serve_fn,
                  forward_fn, tail_fn, dev) -> None:
    """e2e, forward and tail ms by CUDA events at each request size, and
    the device's busy share of the largest."""
    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        e2e = cuda_ms(lambda: serve_fn(x), **request_timing(n))
        with torch.inference_mode():
            fwd = cuda_ms(lambda: forward_fn(x), **request_timing(n))
            out = forward_fn(x)
        tail = cuda_ms(lambda: tail_fn(out))
        extra = ""
        if n == batches[-1].shape[0]:
            busy, window = device_busy_ms(lambda: serve_fn(x))
            extra = (f"; device busy {busy:.3f} ms a call = "
                     f"{100 * busy / e2e:.1f}% of the untraced call "
                     f"(traced {window:.3f} ms)")
        log(f"{name} {size} bs {n} bf16 on [{card}]: e2e {e2e:.3f} ms = "
            f"{n * 1000 / e2e:.1f} img/s; forward-only {fwd:.3f} ms = "
            f"{n * 1000 / fwd:.1f} img/s; tail {tail:.3f} ms{extra}")
        del out, x


def timed_steps(state, train_step, batches, steps: int) -> tuple:
    """``steps`` steps over ``batches`` in turn: (state, metrics, ms a step
    over the steps after the first half, peak GB)."""
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = steps // 2
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = train_step(state, batches[i % len(batches)])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
    return (state, metrics, step_ms,
            torch.cuda.max_memory_allocated() / 1e9)


def check_finite(metrics, keys, what: str) -> None:
    for i, m in enumerate(metrics):
        for key in keys:
            if not bool(torch.isfinite(torch.as_tensor(m[key]))):
                raise AssertionError(f"{what} step {i}: {key} = "
                                     f"{float(m[key])}")


def f32_outputs_gap(dev, cfg, images, keys, what: str) -> str:
    """The float32 model of ``cfg`` on the card against the CPU, the same
    weights and uint8 ``images``: each output key's largest error within
    1e-4 of its largest magnitude (lists: each level)."""
    from yolov7_d2_tpu_torch.models.build import build_model

    f32 = dataclasses.replace(cfg, amp=False,
                              input_size=tuple(images.shape[1:3]))
    with torch.inference_mode():
        ref = build_model(f32, "cpu", SEED)(images)
        card = build_model(f32, dev, SEED)(images.to(dev))
    gaps = []
    for k in keys:
        pairs = (list(zip(ref[k], card[k])) if isinstance(ref[k], list)
                 else [(ref[k], card[k])])
        worst = 0.0
        for r, c in pairs:
            scale = float(r.abs().max())
            err = float((c.float().cpu() - r).abs().max())
            if err > 1e-4 * max(scale, 1e-6):
                raise AssertionError(f"{what} {k} on the card differs from "
                                     f"the CPU by {err} of {scale}")
            worst = max(worst, err / max(scale, 1e-6))
        gaps.append(f"{k} {worst:.3g}")
    return f"f32 card against CPU at {images.shape[1]} px: " + ", ".join(
        gaps) + " of the max"


def normalize_608_entry(kernels: dict, images: torch.Tensor) -> None:
    """The normalize kernel at SparseInst's mean and std on u8 [128, 608,
    608, 3] against its plain version, bit-exact (``torch.equal``): the
    ``normalize_608`` entry, whose launches are (a)'s."""
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as si

    args = (images, si.PIXEL_MEAN, si.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at SparseInst's statistics, 608 px")
    kernels["normalize_608"] = {
        "name": "normalize_608", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_608 plain"),
        # no one PyTorch call takes uint8 NHWC to (x - mean) / std in
        # channels_last
        "library_ms": None,
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
        "launches": 0,
    }
    log(f"(20a) normalize at SparseInst's statistics on "
        f"{tuple(images.shape)}: bit-exact against its plain version")


def dcn_paths(dev, card: str, gen: torch.Generator, kernels: dict,
              requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
              small: int = 128, steps: int = MASK_STEPS,
              cli_images: int = CLI_IMAGES, cli_steps: int = 4,
              **cli_opts) -> None:
    """(20a) SparseInst R-50-DCN GIAM at 608
    (``sparseinst/sparse_inst_r50_dcn_giam_aug.yaml``: DCNv2 in res4 and
    res5, ``GroupIAMDecoder``): the ``normalize_608`` entry; serving through
    ``build_model`` + ``sparseinst_postprocess`` at each request size
    (masks at 1/4), times and the busy share; f32 card against CPU at
    ``small`` px; ``steps`` steps of ``train_n`` through ``build_system``
    (AdamW); ``train_inseg`` for ``cli_steps`` steps on a mini-COCO with
    polygons, the blend mosaic on. Launches counted from 0 a path, added
    to ``normalize_608``."""
    from yolov7_d2_tpu_torch import train_inseg
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as si
    from yolov7_d2_tpu_torch.ops.deform_conv import DeformConv
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    cfg = coco_cfg(DCN_YAML)
    size = cfg.input_size[0]
    big = torch.randint(0, 256, (requests[-1], size, size, 3),
                        generator=gen, dtype=torch.uint8).to(dev)
    normalize_608_entry(kernels, big)
    del big
    model = build_model(cfg, dev, SEED)
    dcn = [n for n, m in model.named_modules() if isinstance(m, DeformConv)]
    log(f"(20a) SparseInst R-50-DCN {size} from {DCN_YAML}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters, {model.dtype}, {len(dcn)} DCNv2 layers "
        f"({dcn[0]} .. {dcn[-1]}), groups {cfg.groups}")
    batches = [letterboxed_batch(n, gen, size) for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = sparseinst_serve(model, cfg, req.to(dev))
        log(f"(20a) request bs {req.shape[0]}: " + check_inst_detections(
            dets, req.shape[0], cfg, size, "SparseInst-DCN serving"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if launches.get("normalize", 0) != len(requests):
        raise AssertionError(f"SparseInst-DCN serving launches {launches}")
    kernels["normalize_608"]["launches"] += launches["normalize"]
    serving_times(
        card, "SparseInst R-50-DCN", size, batches,
        lambda x: sparseinst_serve(model, cfg, x), model,
        lambda out: si.sparseinst_postprocess(
            out, cfg.cls_threshold, cfg.mask_threshold, cfg.max_detections),
        dev)
    del model, batches, dets
    torch.cuda.empty_cache()
    one = letterboxed_batch(2, gen, small)
    log("(20a) SparseInst-DCN " + f32_outputs_gap(
        dev, cfg, one, ("cls_logits", "obj_logits", "mask_logits"),
        "SparseInst-DCN"))

    _, state, train_step, _ = build_system(cfg, device=dev, seed=SEED)
    frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [inseg_batch(train_n, gen, dev, size) for _ in range(2)]
    build.reset_launches()
    state, metrics, step_ms, peak = timed_steps(state, train_step, tbatches,
                                                steps)
    launches = dict(build.LAUNCHES)
    if launches.get("normalize", 0) != steps:
        raise AssertionError(f"SparseInst-DCN training launches {launches}")
    kernels["normalize_608"]["launches"] += launches["normalize"]
    check_finite(metrics, ("loss_ce", "loss_dice", "loss_mask",
                           "loss_objectness", "total_loss", "grad_norm"),
                 "SparseInst-DCN")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError("SparseInst-DCN training moved no parameter")
    if not all(torch.equal(a, b)
               for a, b in zip(frozen, frozen_bn_buffers(state.model))):
        raise AssertionError("SparseInst-DCN training moved FrozenBN "
                             "statistics")
    offsets = [m.offset_conv.weight for m in state.model.modules()
               if isinstance(m, DeformConv)]
    if not all(float(w.detach().abs().max()) > 0 for w in offsets):
        raise AssertionError("an offset convolution stayed at zero")
    log(f"(20a) SparseInst R-50-DCN {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
        f"{steps - steps // 2} steps after {steps // 2}, batches on the "
        f"card); peak memory {peak:.3f} GB; total loss "
        f"{float(metrics[0]['total_loss']):.4f} -> "
        f"{float(metrics[-1]['total_loss']):.4f}; every offset convolution "
        "moved off zero, FrozenBN statistics did not")
    del state, train_step, tbatches, metrics, before, frozen, offsets
    torch.cuda.empty_cache()

    work = os.path.join(REPO, "build", "chip_smoke_dcn")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=cli_images, segm=True)
    register_coco_instances(INSEG_DATASET, {}, js, img_dir)
    opts = {"DATASETS.TRAIN": (INSEG_DATASET,),
            "DATASETS.TEST": (INSEG_DATASET,),
            "OUTPUT_DIR": os.path.join(work, "out"), "SEED": SEED,
            "SOLVER.IMS_PER_BATCH": train_n, "SOLVER.MAX_ITER": cli_steps,
            "SOLVER.CHECKPOINT_PERIOD": cli_steps,
            "INPUT.MOSAIC.ENABLED": True,
            "INPUT.MOSAIC.MOSAIC_HEIGHT": size,
            "INPUT.MOSAIC.MOSAIC_WIDTH": size,
            **{k.replace("__", "."): v for k, v in cli_opts.items()}}
    argv = ["--config-file", os.path.join(REPO, "configs", "coco", DCN_YAML)]
    for k, v in opts.items():
        argv += [k, v if isinstance(v, str) else repr(v)]
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        run = train_inseg.main(default_argument_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        latest = run.storage.latest()
        for key in ("total_loss", "loss_ce", "loss_dice", "loss_mask",
                    "loss_objectness", "grad_norm"):
            if not math.isfinite(latest.get(key, float("nan"))):
                raise AssertionError(f"train_inseg DCN: {key} = "
                                     f"{latest.get(key)}")
        if launches.get("normalize", 0) != cli_steps:
            raise AssertionError(f"train_inseg DCN launches {launches}")
        kernels["normalize_608"]["launches"] += launches["normalize"]
        log(f"(20a) train_inseg {DCN_YAML} on [{card}], {train_n} images a "
            f"step, blend mosaic on: time_per_iter median "
            f"{run.storage.median('time_per_iter') * 1e3:.3f} ms; "
            f"{cli_steps} steps in {wall:.2f} s (build included); total "
            f"loss {latest['total_loss']:.4f}; launches {launches}")
        del run
    finally:
        DatasetCatalog.remove(INSEG_DATASET)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def solov2_paths(dev, card: str, gen: torch.Generator, kernels: dict,
                 requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                 small: int = 128, steps: int = MASK_STEPS) -> None:
    """(20b) SOLOv2 R-50 at 640 (``solov2/solov2_r50.yaml``): serving
    through ``build_model`` + ``solov2_postprocess`` (the JAX defaults;
    masks at 1/4) at each request size, the normalize kernel at SOLOv2's
    statistics (SparseInst's: its launches go to ``normalize_sparseinst``),
    times and the busy share; the tail once more at bs 8 with score
    threshold 0, which the random weights need for candidates, and
    ``solov2_upsample_masks`` of bs 1 and 8 on it; f32 card against CPU at
    ``small`` px; ``steps`` steps of ``train_n`` through ``build_system``
    with masks and boxes (SGD). (The tail's run at threshold 0 also keeps
    every non-empty mask, update threshold 0.)"""
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.models.build import build_model
    from yolov7_d2_tpu_torch.models.meta_arch import solov2 as sv

    cfg = coco_cfg(SOLOV2_YAML)
    size = cfg.input_size[0]
    hm = size // 4
    model = build_model(cfg, dev, SEED)
    log(f"(20b) SOLOv2 R-50 {size} from {SOLOV2_YAML}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters, {model.dtype}, grids {cfg.num_grids}")
    batches = [letterboxed_batch(n, gen, size) for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = solov2_serve(model, cfg, req.to(dev))
        log(f"(20b) request bs {req.shape[0]}: " + check_mask_detections(
            dets, req.shape[0], hm, "SOLOv2 serving", need=False))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if launches.get("normalize", 0) != len(requests):
        raise AssertionError(f"SOLOv2 serving launches {launches}")
    kernels["normalize_sparseinst"]["launches"] += launches["normalize"]
    serving_times(card, "SOLOv2 R-50", size, batches,
                  lambda x: solov2_serve(model, cfg, x), model,
                  sv.solov2_postprocess, dev)
    x = batches[1].to(dev)
    _, dets = solov2_serve(model, cfg, x, score_thr=0.0, update_thr=0.0)
    summary = check_mask_detections(dets, x.shape[0], hm,
                                    "SOLOv2 tail at score 0")
    kept = []
    t0 = time.perf_counter()
    for n in (1, x.shape[0]):
        for i in range(n):
            filled = (batches[1][i] != 114).any(-1)
            vh = int(filled.any(1).nonzero().max()) + 1
            vw = int(filled.any(0).nonzero().max()) + 1
            bm, boxes = sv.solov2_upsample_masks(
                dets.masks[i][dets.valid[i]], (size, size), (vh, vw))
            if bm.shape[1:] != (vh, vw) or boxes.shape[-1] != 4:
                raise AssertionError(f"solov2_upsample_masks gave "
                                     f"{tuple(bm.shape)}")
            kept.append(int(bm.any((1, 2)).sum()))
    torch.cuda.synchronize()
    log(f"(20b) the tail at score threshold 0, bs {x.shape[0]}: {summary};"
        f" solov2_upsample_masks of bs 1 and {x.shape[0]}: non-empty masks "
        f"{kept} ({(time.perf_counter() - t0) * 1e3:.1f} ms host clock)")
    del model, batches, dets, x
    torch.cuda.empty_cache()
    one = letterboxed_batch(2, gen, small)
    log("(20b) SOLOv2 " + f32_outputs_gap(
        dev, cfg, one, ("cate_preds", "kernel_preds", "mask_feats"),
        "SOLOv2"))

    _, state, train_step, fields = build_system(cfg, device=dev, seed=SEED)
    before = [p.detach().clone() for p in state.model.parameters()]
    tbatches = [{k: v for k, v in mask_batch(train_n, gen, dev, size).items()
                 if k in fields} for _ in range(2)]
    build.reset_launches()
    state, metrics, step_ms, peak = timed_steps(state, train_step, tbatches,
                                                steps)
    launches = dict(build.LAUNCHES)
    if launches.get("normalize", 0) != steps:
        raise AssertionError(f"SOLOv2 training launches {launches}")
    kernels["normalize_sparseinst"]["launches"] += launches["normalize"]
    check_finite(metrics, ("loss_cate", "loss_mask", "total_loss",
                           "grad_norm"), "SOLOv2")
    if not all(float(m["num_pos"]) > 0 for m in metrics):
        raise AssertionError("SOLOv2: a step with no positive cell")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError("SOLOv2 training moved no parameter")
    log(f"(20b) SOLOv2 R-50 {size} train step bs {train_n} bf16 on "
        f"[{card}]: {step_ms:.3f} ms a step = "
        f"{train_n * 1000 / step_ms:.1f} img/s (host clock over "
        f"{steps - steps // 2} steps after {steps // 2}); peak memory "
        f"{peak:.3f} GB; fields {fields}; positive cells a step "
        f"{[int(m['num_pos']) for m in metrics]}; total loss "
        f"{float(metrics[0]['total_loss']):.4f} -> "
        f"{float(metrics[-1]['total_loss']):.4f}")
    del state, train_step, tbatches, metrics, before
    torch.cuda.empty_cache()


def mask_others(dev, card: str, gen: torch.Generator, kernels: dict,
                bs: int = 8,
                train_n: int = TRAIN_BATCH,
                detr_train_n: int = DETR_TRAIN_BATCH,
                detr_size: int = DETR_SIZE, **cli_opts) -> None:
    """(20c) One request of ``bs`` images and one step each of the other
    yamls this section unlocks, at full width and depth and each yaml's
    size: the kernel path's ``Detections`` equal to the plain path's (the
    same pixels as float32 through the normalize kernel's plain version,
    and the plain NMS); the launches counted from 0 a path and added to
    the entries of the same constants (new shapes noted in the log)."""
    from yolov7_d2_tpu_torch.data.device_aug import (
        DevicePhotometric,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.engine import build_system, build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.grid_mask import grid_mask
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain
    from yolov7_d2_tpu_torch.models.meta_arch import detr_seg
    from yolov7_d2_tpu_torch.models.meta_arch import sparseinst as si
    from yolov7_d2_tpu_torch.models.meta_arch import yolomask
    from yolov7_d2_tpu_torch.predictor import Predictor

    def count(what, got, want, entry):
        for kernel, n in want.items():
            if got.get(kernel, 0) != n:
                raise AssertionError(f"{what} launches {got}")
            kernels[entry[kernel]]["launches"] += n

    # the vd DCN SparseInst yamls at 608 and SOLOv2-lite at 448
    for yaml, entry in ((DCN_OTHERS[0], "normalize_608"),
                        (DCN_OTHERS[1], "normalize_608"),
                        (SOLOV2_LITE_YAML, "normalize_sparseinst")):
        cfg = coco_cfg(yaml)
        size = cfg.input_size[0]
        model, state, train_step, fields = build_system(cfg, device=dev,
                                                        seed=SEED)
        model.eval()
        req = letterboxed_batch(bs, gen, size).to(dev)
        sparse = cfg.meta_architecture == "SparseInst"
        serve = ((lambda x: sparseinst_serve(model, cfg, x)) if sparse
                 else (lambda x: solov2_serve(model, cfg, x)))
        build.reset_launches()
        _, dets = serve(req)
        torch.cuda.synchronize()
        serve_l = dict(build.LAUNCHES)
        _, plain = serve(req.float())
        equal_detections(dets, plain, yaml)
        summary = (check_inst_detections(dets, bs, cfg, size, yaml) if sparse
                   else check_mask_detections(dets, bs, size // 4, yaml,
                                              need=False))
        model.train()
        batch = (inseg_batch(train_n, gen, dev, size) if sparse
                 else {k: v for k, v in mask_batch(train_n, gen, dev,
                                                   size).items()
                       if k in fields})
        build.reset_launches()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        train_l = dict(build.LAUNCHES)
        check_finite([m], ("total_loss", "grad_norm"), yaml)
        count(yaml, serve_l, {"normalize": 1}, {"normalize": entry})
        count(yaml, train_l, {"normalize": 1}, {"normalize": entry})
        log(f"(20c) {yaml} ({cfg.meta_architecture}"
            + (f", vd {cfg.resnet.vd}, DCN {cfg.resnet.deform_on_per_stage}"
               if sparse else f", grids {cfg.num_grids}")
            + f") at {size}: bs {bs} {summary}, the kernel path's "
            f"Detections equal the plain path's; one step of {train_n}: total"
            f" loss {float(m['total_loss']):.4f}; launches {serve_l} / "
            f"{train_l} (into {entry}"
            + (", a 448 px shape" if size == 448 else "") + ")")
        del model, state, train_step, dets, plain, batch
        torch.cuda.empty_cache()

    # YOLOX on DLA-34 through the Predictor, its step with GridMask on
    cfg = coco_cfg(DLA_YAML, grid_mask=True)
    size = cfg.input_size[0]
    model, state, train_step = build_yolox_system(cfg, device=dev,
                                                  seed=SEED)
    predictor = Predictor(cfg, device=dev, model=model.eval())
    req = letterboxed_batch(bs, gen, size).to(dev)
    build.reset_launches()
    dets = predictor.predict_batch(req)
    torch.cuda.synchronize()
    serve_l = dict(build.LAUNCHES)
    with torch.inference_mode():
        plain = predictor.postprocess(model(req.float()),
                                      nms=nms_batched_plain)
    equal_detections(dets, plain, DLA_YAML)
    summary = check_detections(dets, bs, cfg, DLA_YAML)
    model.train()
    step = make_packed_photo_step(cfg, train_step, seed=SEED)
    build.reset_launches()
    state, m = step(state, {k: v.to(dev) for k, v in train_batch(
        train_n, gen, size).items()})
    torch.cuda.synchronize()
    train_l = dict(build.LAUNCHES)
    check_yolox_metrics([m], DLA_YAML)
    count(DLA_YAML, serve_l, {"normalize": 1, "nms": 1},
          {"normalize": "normalize", "nms": "nms"})
    count(DLA_YAML, train_l, {"grid_mask": 1}, {"grid_mask": "grid_mask"})
    log(f"(20c) YOLOX on DLA-34 ({DLA_YAML}, neck on "
        f"{list(model.backbone.out_channels.values())}) at {size}: bs {bs} "
        f"{summary}, the kernel path's Detections equal the plain path's; "
        f"one step of {train_n} with GridMask ({m['grid_masked']} masked): "
        f"total loss {float(m['total_loss']):.4f}, num_fg "
        f"{float(m['num_fg']):.0f}; launches {serve_l} / {train_l}")
    del model, state, train_step, predictor, step, dets, plain
    torch.cuda.empty_cache()

    # YOLOMask: boxes through anchor_yolo_postprocess, the field's mask
    # recovery as the JAX tests drive it, a step with GridMask on the images
    for yaml in YOLOMASK_YAMLS:
        cfg = coco_cfg(yaml, grid_mask=True)
        size = cfg.input_size[0]
        model, state, train_step, fields = build_system(cfg, device=dev,
                                                        seed=SEED)
        model.eval()
        req = letterboxed_batch(bs, gen, size).to(dev)
        build.reset_launches()
        out, dets = anchor_serve(model, cfg, req)
        torch.cuda.synchronize()
        serve_l = dict(build.LAUNCHES)
        with torch.inference_mode():
            plain = anchor_tail(model(req.float()), cfg,
                                nms=nms_batched_plain)
            # one field of the L x na (ROADMAP.md C.36)
            masks = yolomask.yolomask_recover_masks(
                dets, out["orien"][:, :, :, 0, 0])
        equal_detections(dets, plain, yaml)
        summary = check_detections(dets, bs, cfg, yaml)
        if masks.shape != (bs, cfg.max_detections, size // 4, size // 4):
            raise AssertionError(f"{yaml}: recovered masks "
                                 f"{tuple(masks.shape)}")
        model.train()
        batch = {k: v for k, v in mask_batch(train_n, gen, dev,
                                             size).items() if k in fields}
        draws = DevicePhotometric(cfg).draw(
            torch.Generator().manual_seed(SEED), train_n, size, size)
        build.reset_launches()
        batch["image"] = grid_mask(batch["image"].contiguous(),
                                   draws.grid_params.to(dev).contiguous())
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        train_l = dict(build.LAUNCHES)
        check_finite([m], ("loss_box", "loss_obj_pos", "loss_obj_neg",
                           "loss_cls", "loss_orien_pos", "loss_orien_neg",
                           "total_loss", "grad_norm"), yaml)
        count(yaml, serve_l, {"normalize": 1, "nms": 1},
              {"normalize": "normalize", "nms": "nms"})
        count(yaml, train_l, {"grid_mask": 1, "normalize": 1},
              {"grid_mask": "grid_mask_u8", "normalize": "normalize"})
        log(f"(20c) {yaml} (YOLOMask) at {size}: bs {bs} {summary}, the "
            f"kernel path's Detections equal the plain path's, recovered "
            f"masks {tuple(masks.shape)} ({float(masks.mean()):.4f} set); "
            f"one step of {train_n} with GridMask on the uint8 images "
            f"({int((draws.grid_params[:, 0] > 1).sum())} masked): total "
            f"loss {float(m['total_loss']):.4f}, orientation "
            f"{float(m['loss_orien_pos']):.4f} / "
            f"{float(m['loss_orien_neg']):.4f}; launches {serve_l} / "
            f"{train_l}" + (" (320 px shapes)" if size == 320 else ""))
        del model, state, train_step, out, dets, plain, masks, batch
        torch.cuda.empty_cache()

    # DetrSegm at 800: the box and mask tails, a step with gt_masks, and
    # train_transformer (no masks in its feed, as in the JAX script)
    cfg = detr_cfg(DETR_SEGM_YAML, input_size=(detr_size, detr_size))
    model, state, train_step, fields = build_system(cfg, device=dev,
                                                    seed=SEED)
    model.eval()
    req = letterboxed_batch(bs, gen, detr_size).to(dev)
    build.reset_launches()
    out, dets = detr_serve(model, cfg, req)
    torch.cuda.synchronize()
    serve_l = dict(build.LAUNCHES)
    with torch.inference_mode():
        segm = detr_seg.postprocess_segm(out)
        pout = model(req.float())
        plain = detr_tail(pout, cfg)
    equal_detections(dets, plain, DETR_SEGM_YAML)
    if not torch.equal(segm, detr_seg.postprocess_segm(pout)):
        raise AssertionError("DetrSegm masks of the kernel path differ from "
                             "the plain path's")
    summary = check_detections(dets, bs, cfg, DETR_SEGM_YAML)
    model.train()
    batch = detr_batch(detr_train_n, gen, dev, detr_size)
    boxes = batch["gt_boxes"].round().long()
    ys = torch.arange(detr_size, device=dev)
    inside_y = (ys >= boxes[..., 1, None]) & (ys < boxes[..., 3, None])
    inside_x = (ys >= boxes[..., 0, None]) & (ys < boxes[..., 2, None])
    batch["gt_masks"] = (inside_y[..., :, None] & inside_x[..., None, :]
                         & batch["gt_valid"][..., None, None]).to(
        torch.uint8)
    build.reset_launches()
    state, m = train_step(state, {k: batch[k] for k in fields})
    torch.cuda.synchronize()
    train_l = dict(build.LAUNCHES)
    check_finite([m], ("loss_ce", "loss_bbox", "loss_giou", "loss_mask_dice",
                       "loss_mask_focal", "total_loss", "grad_norm"),
                 DETR_SEGM_YAML)
    count(DETR_SEGM_YAML, serve_l, {"normalize": 1},
          {"normalize": "normalize_detr"})
    count(DETR_SEGM_YAML, train_l, {"normalize": 1},
          {"normalize": "normalize_detr"})
    log(f"(20c) {DETR_SEGM_YAML} (DetrSegm) at {detr_size}: bs {bs} "
        f"{summary}, masks {tuple(segm.shape)}; the kernel path's "
        f"Detections and masks equal the plain path's; one step of "
        f"{detr_train_n} with gt_masks: loss_mask_dice "
        f"{float(m['loss_mask_dice']):.4f}, loss_mask_focal "
        f"{float(m['loss_mask_focal']):.4f}, total loss "
        f"{float(m['total_loss']):.4f}; launches {serve_l} / {train_l}")
    del model, state, train_step, out, dets, plain, pout, segm, batch
    torch.cuda.empty_cache()
    detr_cli_run(dev, card, kernels, "20c", "DetrSegm", DETR_SEGM_YAML,
                 detr_train_n, detr_size, 16, 2, resume=False, **cli_opts)


def mask_phase(dev, card: str, gen: torch.Generator, kernels: dict,
               requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
               small: int = 128, steps: int = MASK_STEPS,
               cli_images: int = CLI_IMAGES, cli_steps: int = 4,
               others_bs: int = 8, detr_train_n: int = DETR_TRAIN_BATCH,
               detr_size: int = DETR_SIZE, **cli_opts) -> None:
    """Section 20: deformable convolution and the last mask families, full
    depth and width, bf16 over f32 weights from ``SEED``: (a) SparseInst
    R-50-DCN GIAM at 608 (:func:`dcn_paths`), (b) SOLOv2 R-50 at 640
    (:func:`solov2_paths`), (c) the other yamls they unlock
    (:func:`mask_others`). Logs the section's seconds."""
    t0 = time.perf_counter()
    dcn_paths(dev, card, gen, kernels, requests, train_n, small, steps,
              cli_images, cli_steps, **cli_opts)
    solov2_paths(dev, card, gen, kernels, requests, train_n, small, steps)
    mask_others(dev, card, gen, kernels, others_bs, train_n, detr_train_n,
                detr_size, **cli_opts)
    log(f"(20) section 20 in {time.perf_counter() - t0:.1f} s on [{card}]")


# ---------------------------------------------------------------------------
# section 21: LazyConfig and the R-CNN family
# ---------------------------------------------------------------------------

CONFIGS = os.path.join(REPO, "configs")
RCNN_LSJ = "new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py"  # under configs
PANOPTIC_FILE = "new_baselines/panoptic_fpn_regnetx_0.4g.py"
PANOPTIC_SIZE = 640  # do_train's default input size: the file names none
YOLOX_LAZY = "common/yolox_s_lazy.py"
RCNN_STEPS = 6  # the (a) and (b) steps of 16: 3 warm-up, 3 timed
RCNN_GT_SLOTS = 20


def lazy_files() -> list:
    """The 18 LazyConfig files, relative to ``configs/``."""
    out = []
    for sub in ("common", "new_baselines"):
        for root, _, files in os.walk(os.path.join(CONFIGS, sub)):
            out += [os.path.relpath(os.path.join(root, f), CONFIGS)
                    for f in files if f.endswith(".py")]
    return sorted(out)


def lazy_rcnn_model(name: str, dev, dtype=torch.bfloat16, seed: int = SEED):
    """``configs/<name>`` loaded with the port's ``LazyConfig``, its model
    instantiated in ``dtype`` with weights from ``seed`` (as the
    builders draw them), on ``dev``, eval mode -> (model, loaded config)."""
    from yolov7_d2_tpu_torch.config.lazy import LazyConfig, instantiate
    from yolov7_d2_tpu_torch.models.build import init_weights_

    cfg = LazyConfig.load(os.path.join(CONFIGS, name))
    cfg["model"]["dtype"] = dtype
    model = instantiate(cfg["model"])
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(device=dev, memory_format=torch.channels_last)
    return model.eval(), cfg


def rcnn_train_cfg(name: str, size: int, **opts):
    """The merged ``CfgNode`` that ``build_system`` trains the model of
    ``configs/<name>`` from: its architecture (``MaskRCNN`` or
    ``PanopticFPN``), the file's model arguments, ``size``, bf16, the
    default sampled mode; ``opts`` (keys with dots) override."""
    from yolov7_d2_tpu_torch.config.defaults import get_cfg
    from yolov7_d2_tpu_torch.config.lazy import LazyConfig

    model = LazyConfig.load(os.path.join(CONFIGS, name))["model"]
    arch = {"MaskRCNN": "MaskRCNN", "PanopticFPNShared": "PanopticFPN"}[
        model["_target_"].__name__]
    pairs = {"MODEL.META_ARCHITECTURE": arch,
             "MODEL.ROI_HEADS.NUM_CLASSES": model.get("num_classes", 80),
             "MODEL.RESNETS.DEPTH": model.get("resnet_depth", 50),
             "MODEL.FPN.OUT_CHANNELS": model.get("fpn_channels", 256),
             "MODEL.MASK_ON": model.get("mask_on", True),
             "MODEL.SEM_SEG_HEAD.NUM_CLASSES": model.get("sem_seg_classes",
                                                         54),
             "MODEL.RPN.POST_NMS_TOPK": model.get("num_proposals", 128),
             "INPUT.INPUT_SIZE": [size, size], "SOLVER.AMP.ENABLED": True,
             **opts}
    cfg = get_cfg()
    for k, v in pairs.items():
        cfg.merge_from_list([k, v if isinstance(v, str) else repr(v)])
    return cfg


def rcnn_batch(n: int, gen: torch.Generator, dev, size: int, model,
               fields, slots: int = RCNN_GT_SLOTS) -> dict:
    """A training batch of the R-CNN family: uint8 letterboxed images [n,
    size, size, 3]; ``slots`` GT slots an image, 6-14 valid: the first 6
    a few pixels off 6 of ``model``'s serving proposals on these images
    (the step's first proposals, so that some are foreground), the rest
    random boxes of 16 px to half the image; classes; with ``gt_masks``,
    each box's rectangle less its top-left quarter (uint8 [n, slots, size,
    size]); with ``gt_sem_seg``, 64 px blocks of the stuff classes and the
    ignore label (int32 [n, size, size])."""
    images = letterboxed_batch(n, gen, size).to(dev)
    with torch.inference_mode():
        props = model(images)["proposals"].float()
    xy = torch.rand((n, slots, 2), generator=gen) * (size - 16)
    wh = 16 + torch.rand((n, slots, 2), generator=gen) * (size // 2 - 16)
    boxes = torch.cat([xy, (xy + wh).clamp(max=size)], -1).to(dev)
    # a twentieth of the proposal's side at most off each edge: IoU > 0.8
    side = (props[:, :6, 2:] - props[:, :6, :2]).repeat(1, 1, 2)
    jitter = (torch.rand((n, 6, 4), generator=gen) * 0.1 - 0.05).to(dev)
    boxes[:, :6] = (props[:, :6] + jitter * side).clamp(0, size)
    count = torch.randint(6, 15, (n, 1), generator=gen)
    valid = (torch.arange(slots)[None] < count).to(dev)
    boxes = boxes * valid[..., None]
    classes = model.num_classes if hasattr(model, "num_classes") else 80
    batch = {"image": images, "gt_boxes": boxes, "gt_valid": valid,
             "gt_classes": (torch.randint(0, classes, (n, slots),
                                          generator=gen).to(dev)
                            * valid).to(torch.int32)}
    if "gt_masks" in fields:
        grid = torch.arange(size, device=dev, dtype=torch.float32)
        x0, y0, x1, y1 = boxes.unbind(-1)
        inside_y = ((grid >= y0[..., None]) & (grid < y1[..., None]))
        inside_x = ((grid >= x0[..., None]) & (grid < x1[..., None]))
        corner_y = grid < ((y0 + y1) / 2)[..., None]
        corner_x = grid < ((x0 + x1) / 2)[..., None]
        masks = (inside_y[..., :, None] & inside_x[..., None, :]
                 & ~(corner_y[..., :, None] & corner_x[..., None, :]))
        batch["gt_masks"] = masks.to(torch.uint8)
    if "gt_sem_seg" in fields:
        stuff = model.sem_seg_classes
        grid = torch.arange(size, device=dev) // 64
        batch["gt_sem_seg"] = ((grid[:, None] * 7 + grid[None, :] * 3)
                               % (stuff + 1)).to(torch.int32).expand(
            n, size, size).contiguous()
    return batch


def rpn_instance(model, size: int) -> str:
    """The launch count of the NMS kernel instance that takes the RPN's
    candidates at ``size``: 5 levels of min(``pre_nms_topk``, 3 anchors a
    cell), 1280 at 1024 and 640 px (the 2048 instance)."""
    rcnn = getattr(model, "rcnn", model)
    cand = sum(min(rcnn.pre_nms_topk, 3 * math.ceil(size / s) ** 2)
               for s in (4, 8, 16, 32, 64))
    return "nms" if cand <= 1024 else "nms_2048"


def rcnn_serve(model, images, nms=None):
    """uint8 batch -> the normalize kernel and the model (the RPN's NMS
    kernel) -> ``mask_rcnn_postprocess`` (the tail's NMS kernel); ``nms``
    replaces both NMS calls (the plain version)."""
    from yolov7_d2_tpu_torch.models.meta_arch import mask_rcnn as mr

    kernel = mr.nms_batched
    if nms is not None:
        mr.nms_batched = nms
    try:
        with torch.inference_mode():
            out = model(images)
            return out, mr.mask_rcnn_postprocess(out, nms=nms or kernel)
    finally:
        mr.nms_batched = kernel


def serving_launches(model, size: int, requests: int) -> dict:
    """A request's launches: the normalize kernel, the RPN's NMS and the
    tail's (the 1024 instance)."""
    launches = collections.Counter(normalize=requests, nms=requests)
    launches[rpn_instance(model, size)] += requests
    return dict(launches)


def check_rcnn_detections(dets, n: int, what: str) -> str:
    if dets.boxes.shape != (n, 100, 4) or dets.masks is not None:
        raise AssertionError(f"{what}: Detections {tuple(dets.boxes.shape)}"
                             f", masks {dets.masks is not None}")
    counts = dets.num_valid()
    if int(counts.min()) < 1:
        raise AssertionError(f"{what}: an image with no detection")
    if not torch.isfinite(dets.boxes[dets.valid]).all():
        raise AssertionError(f"{what}: non-finite boxes")
    return f"detections per image {int(counts.min())}-{int(counts.max())}"


def rcnn_kernel_entries(kernels: dict, images: torch.Tensor,
                        rpn: tuple) -> None:
    """``normalize_rcnn``: the normalize kernel at detectron2's BGR
    statistics on u8 ``images`` [128, 1024, 1024, 3] into bf16, bit-exact;
    ``nms_rpn``: the NMS kernel's 2048 instance on the RPN's candidates of
    one bs-128 forward (``rpn`` = boxes [128, 1280, 4], scores), class
    agnostic at 0.7 to 128, index-exact. Launches are counted by the
    paths."""
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.models.meta_arch import mask_rcnn as mr

    args = (images, mr.PIXEL_MEAN, mr.PIXEL_STD, torch.bfloat16)
    got, want = normalize_images(*args), normalize_images_plain(*args)
    torch.cuda.synchronize()
    if got.stride() != want.stride() or not torch.equal(got, want):
        raise AssertionError("normalize kernel differs from its plain "
                             "version at Mask R-CNN's statistics, 1024 px")
    kernels["normalize_rcnn"] = {
        "name": "normalize_rcnn", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": kernel_ms(lambda: normalize_images(*args)),
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*args),
                              host_ok="normalize_rcnn plain"),
        "library_ms": None,  # no one PyTorch call: u8 NHWC -> normalized
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
        "launches": 0,
    }
    del got, want
    boxes, scores = rpn
    got = nms_batched(boxes, scores, 0.7, 128)
    want = nms_batched_plain(boxes, scores, 0.7, 128)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("NMS kernel differs from its plain version on "
                             f"the RPN's {tuple(scores.shape)} candidates")
    kernels["nms_rpn"] = {
        "name": "nms_rpn", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/nms.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_nms.py:34",
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "ms": kernel_ms(lambda: nms_batched(boxes, scores, 0.7, 128)),
        "plain_ms": kernel_ms(lambda: nms_batched_plain(boxes, scores, 0.7,
                                                      128),
                              host_ok="nms_rpn plain"),
        "library_ms": None,  # no torchvision: no PyTorch call does NMS
        # the greedy walk's IoU tests on this data, ~15 float32 operations
        # each; boxes and scores read once, indices and flags written once
        **bound((boxes.numel() + scores.numel()) * 4 + got[1].numel() * 5,
                float(nms_walk_pairs(scores, *got, 128)) * 15),
        "launches": 0,
    }
    log(f"(21a) normalize at Mask R-CNN's statistics on "
        f"{tuple(images.shape)}: bit-exact; the NMS kernel on the RPN's "
        f"{tuple(scores.shape)} candidates at 0.7: index-exact, kept "
        f"{int(got[1].sum(1).min())}-{int(got[1].sum(1).max())} an image")


def capture_rpn_inputs(model, images) -> tuple:
    """The boxes and scores the RPN hands the NMS in one forward."""
    from yolov7_d2_tpu_torch.models.meta_arch import mask_rcnn as mr

    kernel, seen = mr.nms_batched, []

    def record(boxes, scores, thr, max_out):
        seen.append((boxes.clone(), scores.clone()))
        return kernel(boxes, scores, thr, max_out)

    mr.nms_batched = record
    try:
        with torch.inference_mode():
            model(images)
    finally:
        mr.nms_batched = kernel
    return seen[0]


def rcnn_serving_times(card: str, name: str, size: int, batches, model,
                       dev, iters: int = ITERS) -> None:
    """e2e, forward and tail ms by CUDA events at each request size (3
    calls after 1 at the largest), the device's busy share of the
    largest."""
    from yolov7_d2_tpu_torch.models.meta_arch.mask_rcnn import (
        mask_rcnn_postprocess,
    )

    for req in batches:
        n = req.shape[0]
        x = req.to(dev)
        big = n == batches[-1].shape[0]
        kw = dict(warmup=1, iters=3) if big else dict(iters=iters)
        e2e = cuda_ms(lambda: rcnn_serve(model, x), **kw)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model(x), **kw)
            out = model(x)
            tail = cuda_ms(lambda: mask_rcnn_postprocess(out), **kw)
        extra = ""
        if big:
            busy, window = device_busy_ms(lambda: rcnn_serve(model, x),
                                          calls=2)
            extra = (f"; device busy {busy:.3f} ms a call = "
                     f"{100 * busy / e2e:.1f}% of the untraced call "
                     f"(traced {window:.3f} ms)")
        log(f"{name} {size} bs {n} bf16 on [{card}]: e2e {e2e:.3f} ms = "
            f"{n * 1000 / e2e:.1f} img/s; forward-only {fwd:.3f} ms = "
            f"{n * 1000 / fwd:.1f} img/s; tail {tail:.3f} ms{extra}")
        del out, x


def rcnn_f32_gap(dev, name: str, size: int, gen: torch.Generator) -> str:
    """The float32 model of ``configs/<name>`` on the card against the
    CPU, the same weights and one uint8 image at ``size``: the RPN's
    outputs within 1e-4 of their max; the proposals, and the box and mask
    heads' outputs on the proposals both sides kept (a proposal whose IoU
    with the NMS threshold sits within the sides' rounding may differ)."""
    images = letterboxed_batch(1, gen, size)
    outs = []
    for where in ("cpu", dev):
        model, _ = lazy_rcnn_model(name, where, torch.float32)
        with torch.inference_mode():
            outs.append({k: v.cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in model(images.to(where)).items()})
        del model
    ref, card = outs
    gaps = []

    def gap(key, r, c):
        scale = float(r.abs().max())
        err = float((c.float() - r).abs().max())
        if err > 1e-4 * max(scale, 1e-6):
            raise AssertionError(f"{name} {key}: the card differs from the "
                                 f"CPU by {err} of {scale}")
        gaps.append(f"{key} {err / max(scale, 1e-6):.3g}")

    for key in ("rpn_obj", "rpn_deltas"):
        gap(key, ref[key], card[key])
    same = ((card["proposals"] - ref["proposals"]).abs().amax(-1)
            <= 1e-3)[0] & ref["proposal_valid"][0]
    if float(same.float().mean()) < 0.9:
        raise AssertionError(f"{name}: only {int(same.sum())} proposals "
                             "the same on the card and the CPU")
    for key in ("cls_logits", "box_deltas", "mask_logits"):
        if key in ref:
            gap(key, ref[key][0][same], card[key][0][same])
    return (f"f32 card against CPU at {size} px: " + ", ".join(gaps)
            + f" of the max; {int(same.sum())} of "
            f"{int(ref['proposal_valid'].sum())} proposals the same")


def rcnn_step_gap(dev, name: str, gen: torch.Generator,
                  size: int = 256) -> str:
    """One float32 ``build_system`` step (expectation mode, 2 images at
    ``size``) on the card against the CPU: the loss terms and the gradient
    norm within 1e-3 relative."""
    from yolov7_d2_tpu_torch.engine import build_system

    cfg = rcnn_train_cfg(name, size, **{"SOLVER.AMP.ENABLED": False,
                                        "MODEL.ROI_HEADS.SAMPLE_MODE":
                                        "expectation"})
    metrics, batch = {}, None
    for where in ("cpu", dev):
        _, state, step, fields = build_system(cfg, device=where, seed=SEED)
        if batch is None:
            model, _ = lazy_rcnn_model(name, "cpu", torch.float32)
            batch = rcnn_batch(2, gen, "cpu", size, model, fields)
            del model
        _, m = step(state, {k: v.to(where) for k, v in batch.items()})
        metrics[str(where)] = {k: float(v) for k, v in m.items()}
    ref, card = metrics["cpu"], metrics[str(dev)]
    if not ref["loss_box_reg"] > 0 or not ref["loss_mask"] > 0:
        raise AssertionError(f"{name} f32 step: no foreground proposal")
    for k, v in ref.items():
        if abs(card[k] - v) > 1e-3 * max(abs(v), 1e-6):
            raise AssertionError(f"{name} f32 step {k}: card {card[k]}, CPU "
                                 f"{v}")
    return ("f32 step (expectation, 2 images at "
            f"{size}) card / CPU: " + ", ".join(
                f"{k} {card[k]:.6g} / {ref[k]:.6g}" for k in sorted(ref)))


def rcnn_train_path(dev, card: str, gen: torch.Generator, kernels: dict,
                    name: str, size: int, serving_model, train_n: int,
                    steps: int, label: str) -> None:
    """``steps`` ``build_system`` steps of ``train_n`` images at ``size``
    (bf16, sampled mode) of ``configs/<name>``'s architecture: finite
    losses, foreground proposals on the first step (a box and a mask
    term), weights moved and FrozenBN statistics not, ms a step, peak
    memory; the launches go into ``normalize_rcnn`` and ``nms_rpn``."""
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.models.backbones.resnet import (
        frozen_bn_buffers,
    )

    cfg = rcnn_train_cfg(name, size)
    _, state, train_step, fields = build_system(cfg, device=dev, seed=SEED)
    batches = [rcnn_batch(train_n, gen, dev, size, serving_model, fields)
               for _ in range(2)]
    frozen = [b.clone() for b in frozen_bn_buffers(state.model)]
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    build.reset_launches()
    state, metrics, step_ms, peak = timed_steps(state, train_step, batches,
                                                steps)
    launches = dict(build.LAUNCHES)
    rpn = rpn_instance(state.model, size)
    if launches != {"normalize": steps, rpn: steps}:
        raise AssertionError(f"{label} training launches {launches}")
    kernels["normalize_rcnn"]["launches"] += launches["normalize"]
    kernels["nms_rpn"]["launches"] += launches.get("nms_2048", 0)
    keys = ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
            "total_loss", "grad_norm"]
    keys += [k for k in ("loss_mask", "loss_sem_seg") if k in metrics[0]]
    check_finite(metrics, keys, label)
    first = metrics[0]
    if not float(first["loss_box_reg"]) > 0 or not float(
            first.get("loss_mask", 1.0)) > 0:
        raise AssertionError(f"{label}: no foreground proposal on the first "
                             "step")
    if all(torch.equal(a, b.detach())
           for a, b in zip(before, state.model.parameters())):
        raise AssertionError(f"{label} training moved no parameter")
    if not all(torch.equal(a, b)
               for a, b in zip(frozen, frozen_bn_buffers(state.model))):
        raise AssertionError(f"{label} training moved FrozenBN statistics")
    log(f"{label} train step bs {train_n} bf16 on [{card}], sampled mode: "
        f"{step_ms:.3f} ms a step = {train_n * 1000 / step_ms:.1f} img/s "
        f"(host clock over {steps - steps // 2} steps after {steps // 2}, "
        f"batches on the card); peak memory {peak:.3f} GB; fields {fields}; "
        "first step " + ", ".join(f"{k} {float(first[k]):.4f}"
                                  for k in keys)
        + f"; total loss -> {float(metrics[-1]['total_loss']):.4f}; weights "
        f"moved, FrozenBN statistics did not; launches {launches}")
    del state, train_step, batches, metrics, before, frozen
    torch.cuda.empty_cache()


def mask_rcnn_paths(dev, card: str, gen: torch.Generator, kernels: dict,
                    requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                    steps: int = RCNN_STEPS, small: int = 512,
                    step_px: int = 256, size=None) -> None:
    """(21a) Mask R-CNN R-50-FPN from ``configs/new_baselines/
    mask_rcnn_R_50_FPN_100ep_LSJ.py`` (the port's ``LazyConfig`` and
    ``instantiate``) at its ``train.input_size``: the kernel entries,
    serving at each request size (K2, the model with the RPN's NMS, the
    tail's NMS), the kernel path against the plain one, times and the busy
    share, f32 card against CPU at ``small`` px; the step of ``train_n``
    through ``build_system``; one f32 step card against CPU. ``size``
    replaces the file's size (a rehearsal's)."""
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched_plain

    model, lazy = lazy_rcnn_model(RCNN_LSJ, dev)
    size = size or int(lazy["train"]["input_size"][0])
    log(f"(21a) Mask R-CNN R-50-FPN {size} from {RCNN_LSJ}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters, {model.dtype}, masks {model.mask_on}, "
        f"{model.num_proposals} proposals, {model.pre_nms_topk} candidates "
        "a level")
    batches = [letterboxed_batch(n, gen, size) for n in requests]
    big = batches[-1].to(dev)
    rcnn_kernel_entries(kernels, big, capture_rpn_inputs(model, big))
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        _, dets = rcnn_serve(model, req.to(dev))
        log(f"(21a) request bs {req.shape[0]}: " + check_rcnn_detections(
            dets, req.shape[0], "Mask R-CNN serving"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if launches != serving_launches(model, size, len(requests)):
        raise AssertionError(f"Mask R-CNN serving launches {launches}")
    kernels["normalize_rcnn"]["launches"] += launches["normalize"]
    kernels["nms_rpn"]["launches"] += launches.get("nms_2048", 0)
    _, with_kernel = rcnn_serve(model, big)
    _, with_plain = rcnn_serve(model, big, nms=nms_batched_plain)
    equal_detections(with_kernel, with_plain, "Mask R-CNN bs "
                     f"{big.shape[0]}", fields=("valid", "classes", "boxes",
                                                "scores"))
    log(f"(21a) bs {big.shape[0]}: the kernel path's Detections equal the "
        f"plain path's (both NMS calls plain); launches {launches}")
    del big, with_kernel, with_plain, dets
    rcnn_serving_times(card, "Mask R-CNN R-50-FPN", size, batches, model,
                       dev)
    del batches
    torch.cuda.empty_cache()
    log("(21a) Mask R-CNN " + rcnn_f32_gap(dev, RCNN_LSJ, small, gen))
    rcnn_train_path(dev, card, gen, kernels, RCNN_LSJ, size, model, train_n,
                    steps, f"(21a) Mask R-CNN R-50-FPN {size}")
    del model
    torch.cuda.empty_cache()
    log("(21a) Mask R-CNN " + rcnn_step_gap(dev, RCNN_LSJ, gen, step_px))


def panoptic_paths(dev, card: str, gen: torch.Generator, kernels: dict,
                   requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
                   steps: int = RCNN_STEPS,
                   size: int = PANOPTIC_SIZE) -> None:
    """(21b) Panoptic FPN from ``configs/new_baselines/
    panoptic_fpn_regnetx_0.4g.py`` (R-50 FPN whatever the name says,
    ROADMAP.md C.40) at ``size``: serving at each request size, the
    semantic logits finite, times; ``combine_semantic_and_instance`` on one
    image's outputs (the detections carry no masks, C.41; stuff regions of
    100 px or more, as the JAX test drives it); the step of
    ``train_n`` with ``gt_sem_seg``."""
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.models.meta_arch.panoptic_fpn import (
        combine_semantic_and_instance,
    )
    from yolov7_d2_tpu_torch.structures.instances import Detections

    model, _ = lazy_rcnn_model(PANOPTIC_FILE, dev)
    log(f"(21b) Panoptic FPN {size} from {PANOPTIC_FILE}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters, {model.sem_seg_classes} stuff classes")
    batches = [letterboxed_batch(n, gen, size) for n in requests]
    torch.cuda.synchronize()
    build.reset_launches()
    for req in batches:
        out, dets = rcnn_serve(model, req.to(dev))
        sem = out["sem_seg_logits"]
        if sem.shape != (req.shape[0], size // 4, size // 4,
                         model.sem_seg_classes) or \
                not torch.isfinite(sem).all():
            raise AssertionError(f"Panoptic FPN semantic logits "
                                 f"{tuple(sem.shape)}")
        log(f"(21b) request bs {req.shape[0]}: " + check_rcnn_detections(
            dets, req.shape[0], "Panoptic FPN serving"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if launches != serving_launches(model, size, len(requests)):
        raise AssertionError(f"Panoptic FPN serving launches {launches}")
    kernels["normalize_rcnn"]["launches"] += launches["normalize"]
    kernels["nms_rpn"]["launches"] += launches.get("nms_2048", 0)
    one = Detections(**{f: getattr(dets, f)[0].cpu() for f in
                        ("boxes", "scores", "classes", "valid")})
    # stuff regions of 100 px or more, as the JAX test drives the fusion
    # (tests/test_mask_rcnn.py:161)
    pan = combine_semantic_and_instance(sem[0].float().cpu().numpy(), one,
                                        stuff_area_limit=100)
    if pan.shape != (size // 4, size // 4) or pan.max() < 1:
        raise AssertionError(f"panoptic fusion {pan.shape}, max {pan.max()}")
    log(f"(21b) combine_semantic_and_instance on image 0 of bs "
        f"{batches[-1].shape[0]}: {len(set(pan.ravel().tolist()) - {0})} "
        f"segments (stuff only: no masks), {float((pan == 0).mean()):.3f} "
        f"void; launches {launches}")
    del out, dets, sem
    rcnn_serving_times(card, "Panoptic FPN R-50", size, batches, model, dev)
    del batches
    rcnn_train_path(dev, card, gen, kernels, PANOPTIC_FILE, size, model,
                    train_n, steps, f"(21b) Panoptic FPN {size}")
    del model
    torch.cuda.empty_cache()


def lazy_other_model(name: str, cfg, model, dev, gen, bs: int,
                     px=None) -> str:
    """One request of ``bs`` images through ``model`` (from ``configs/
    <name>``) and its family's tail, and one ``build_system`` step of the
    architecture at the file's settings (at ``px`` where given, a
    rehearsal's)."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.models.meta_arch.yolox import yolox_postprocess

    kind = type(model).__name__
    size = px or int((cfg.get("train") or {}).get("input_size", (SIZE,))[0])
    if kind in ("MaskRCNN", "PanopticFPNShared"):
        _, dets = rcnn_serve(model, letterboxed_batch(bs, gen, size).to(dev))
        served = check_rcnn_detections(dets, bs, name)
        tcfg = rcnn_train_cfg(name, size)
        _, state, step, fields = build_system(tcfg, device=dev, seed=SEED)
        batch = rcnn_batch(bs, gen, dev, size, model, fields)
    elif kind == "YOLOX":
        with torch.inference_mode():
            dets = yolox_postprocess(model(letterboxed_batch(bs, gen, size)
                                           .to(dev)))
        served = f"detections per image {int(dets.num_valid().min())}"
        ycfg = YoloxConfig(num_classes=model.num_classes,
                           depth_mul=cfg["model"]["depth_mul"],
                           width_mul=cfg["model"]["width_mul"])
        _, state, step, fields = build_system(ycfg, device=dev, seed=SEED)
        batch = {k: v.to(dev) for k, v in train_batch(bs, gen,
                                                      size).items()}
    elif kind == "DETR":
        size = px or DETR_SIZE
        dcfg = detr_cfg(DETR_MODELS[0][1], input_size=(size, size))
        _, dets = detr_serve(model, dcfg, letterboxed_batch(bs, gen, size)
                             .to(dev))
        served = f"detections per image {int(dets.num_valid().min())}"
        _, state, step, fields = build_system(dcfg, device=dev, seed=SEED)
        batch = detr_batch(bs, gen, dev, size)
    elif kind == "SparseInst":
        scfg = sparseinst_cfg(groups=cfg["model"]["groups"])
        _, dets = sparseinst_serve(model, scfg, letterboxed_batch(
            bs, gen, size).to(dev))
        served = f"instances per image {int(dets.num_valid().min())}"
        _, state, step, fields = build_system(scfg, device=dev, seed=SEED)
        batch = inseg_batch(bs, gen, dev, size)
    else:
        raise AssertionError(f"{name}: no serving path for {kind}")
    _, metrics = step(state, batch)
    if not math.isfinite(float(metrics["total_loss"])):
        raise AssertionError(f"{name}: total loss {metrics['total_loss']}")
    return (f"{kind} at {size}: bs {bs} {served}; one step of {bs}: total "
            f"loss {float(metrics['total_loss']):.4f}, fields {fields}")


def lazy_others(dev, card: str, gen: torch.Generator, bs: int = 2,
                px=None) -> None:
    """(21c) Each of the other 16 LazyConfig files: loaded, its model
    instantiated where it has one (bf16, weights from the seed), one
    request and one ``build_system`` step (:func:`lazy_other_model`); then
    FasterRCNN through the CfgNode: one request of ``build_model``'s model
    and one step."""
    from yolov7_d2_tpu_torch.config import RcnnConfig
    from yolov7_d2_tpu_torch.config.lazy import LazyConfig, instantiate
    from yolov7_d2_tpu_torch.engine import build_system, config_from_cfg
    from yolov7_d2_tpu_torch.models.build import build_model, init_weights_

    others = [f for f in lazy_files() if f not in (RCNN_LSJ, PANOPTIC_FILE)]
    if len(others) != 16:
        raise AssertionError(f"LazyConfig files: {others}")
    for name in others:
        cfg = LazyConfig.load(os.path.join(CONFIGS, name))
        if "model" not in cfg:
            log(f"(21c) {name}: loaded, keys {sorted(cfg)}")
            continue
        cfg["model"]["dtype"] = torch.bfloat16
        model = instantiate(cfg["model"])
        init_weights_(model, torch.Generator().manual_seed(SEED))
        model = model.to(device=dev,
                         memory_format=torch.channels_last).eval()
        log(f"(21c) {name}: " + lazy_other_model(name, cfg, model, dev, gen,
                                                  bs, px))
        del model
        torch.cuda.empty_cache()
    size = px or SIZE
    tcfg = rcnn_train_cfg(RCNN_LSJ, size, **{"MODEL.META_ARCHITECTURE":
                                             "FasterRCNN"})
    rcfg = config_from_cfg(tcfg)
    if not isinstance(rcfg, RcnnConfig) or rcfg.mask_on:
        raise AssertionError(f"FasterRCNN reads {rcfg}")
    model = build_model(rcfg, dev, SEED)
    _, dets = rcnn_serve(model, letterboxed_batch(bs, gen, size).to(dev))
    served = check_rcnn_detections(dets, bs, "FasterRCNN")
    _, state, step, fields = build_system(tcfg, device=dev, seed=SEED)
    _, metrics = step(state, rcnn_batch(bs, gen, dev, size, model, fields))
    if "loss_mask" in metrics or not math.isfinite(
            float(metrics["total_loss"])):
        raise AssertionError(f"FasterRCNN step {metrics}")
    log(f"(21c) FasterRCNN through the CfgNode at {size}: bs {bs} {served}; "
        f"one step of {bs}: total loss {float(metrics['total_loss']):.4f}, "
        f"fields {fields}")
    del model, state, step
    torch.cuda.empty_cache()


def lazy_entry_points(dev, card: str, images: int = TRAIN_BATCH,
                      steps: int = 4, size: int = SIZE) -> None:
    """(21d) ``lazyconfig_train_net`` on ``configs/common/yolox_s_lazy.py``
    for ``steps`` steps of ``images`` at 640 on the card (its synthetic
    loader), a checkpoint at the end, then ``--resume`` for 2 more;
    ``demo_lazyconfig`` on two of the mini-COCO JPEGs."""
    from yolov7_d2_tpu_torch import demo_lazyconfig, lazyconfig_train_net

    work = os.path.join(REPO, "build", "chip_smoke_lazy")
    shutil.rmtree(work, ignore_errors=True)
    config = os.path.join(CONFIGS, YOLOX_LAZY)

    def argv(max_iter, *flags):
        return ["--config-file", config, "--device", str(dev), *flags,
                f"train.max_iter={max_iter}",
                f"train.ims_per_batch={images}",
                f"train.input_size=({size}, {size})",
                f"train.output_dir={work}",
                f"train.checkpointer={{'period': {steps}}}"]

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = lazyconfig_train_net.main(argv(steps))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ckpts = sorted(os.listdir(os.path.join(work, "ckpt")))
        if first.state.step != steps or ckpts != [f"ckpt_{steps:08d}.pt"]:
            raise AssertionError(f"lazyconfig_train_net: step "
                                 f"{first.state.step}, checkpoints {ckpts}")
        latest = first.storage.latest()
        if not math.isfinite(latest["total_loss"]):
            raise AssertionError(f"lazyconfig_train_net: {latest}")
        resumed = lazyconfig_train_net.main(argv(steps + 2, "--resume"))
        if resumed.start_iter != steps or resumed.state.step != steps + 2:
            raise AssertionError(f"--resume: start {resumed.start_iter}, "
                                 f"step {resumed.state.step}")
        log(f"(21d) lazyconfig_train_net {YOLOX_LAZY} on [{card}], {images} "
            f"images at {size}: {steps} steps in {wall:.2f} s, total loss "
            f"{latest['total_loss']:.4f}, checkpoint {ckpts[0]}; --resume "
            f"from step {resumed.start_iter} to {resumed.state.step}, total "
            f"loss {resumed.storage.latest()['total_loss']:.4f}")
        del first, resumed
        _, img_dir = write_mini_coco(work, n=2)
        jpgs = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
        results = demo_lazyconfig.main(["--config-file", config, "-i", *jpgs,
                                        "--output", os.path.join(work, "vis"),
                                        "-c", "0.0", "--input-size",
                                        str(size), "--device", str(dev)])
        drawn = sorted(os.listdir(os.path.join(work, "vis")))
        if len(results) != 2 or len(drawn) != 2:
            raise AssertionError(f"demo_lazyconfig: {drawn}")
        log(f"(21d) demo_lazyconfig {YOLOX_LAZY} on two mini-COCO JPEGs: "
            + ", ".join(f"{int(d.valid.sum())} detections" for _, d in
                        results) + f", drawn {drawn}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def rcnn_repeat(dev, card: str, gen: torch.Generator, size: int = 256,
                n: int = 4) -> None:
    """(21e) C.14 on this slice: the SparseInst R-50-DCN float32 step (608
    px, 4 images) twice with cuDNN deterministic, bitwise equal (the DCN
    sampling's fixed-order backward); Mask R-CNN's float32 step
    (expectation mode, ``n`` images at ``size``) the same: equal, or the
    first gradient to differ is a library module's (a convolution, a
    linear layer)."""
    from torch import nn

    from yolov7_d2_tpu_torch.engine import build_system

    scfg = coco_cfg(DCN_YAML, amp=False)
    sbatch = inseg_batch(4, gen, dev, scfg.input_size[0])

    def dcn_build():
        _, state, step, _ = build_system(scfg, device=dev, seed=SEED)
        return state, step

    with deterministic_library():
        gaps = repeat_phase(dev, card, "(21e) SparseInst R-50-DCN "
                            f"{scfg.input_size[0]} float32, cuDNN "
                            "deterministic", dcn_build, sbatch)
    if gaps["outputs_differ"] or gaps["params_differ"] or \
            not gaps["weights_equal"]:
        raise AssertionError("C.14 SparseInst R-50-DCN: two runs part at "
                             f"{gaps['output']}")
    del sbatch
    tcfg = rcnn_train_cfg(RCNN_LSJ, size, **{
        "SOLVER.AMP.ENABLED": False,
        "MODEL.ROI_HEADS.SAMPLE_MODE": "expectation"})
    model, _ = lazy_rcnn_model(RCNN_LSJ, dev, torch.float32)
    batch = rcnn_batch(n, gen, dev, size, model, ("gt_masks",))
    del model

    def rcnn_build():
        _, state, step, _ = build_system(tcfg, device=dev, seed=SEED)
        return state, step

    with deterministic_library():
        gaps = repeat_phase(dev, card, f"(21e) Mask R-CNN {size} float32 "
                            "expectation, cuDNN deterministic", rcnn_build,
                            batch)
    if gaps["outputs_differ"] or gaps["params_differ"] or \
            not gaps["weights_equal"]:
        _, state, _, _ = build_system(tcfg, device=dev, seed=SEED)
        module = gaps["output"].rpartition("[")[0]
        found = dict(state.model.named_modules()).get(module)
        if not isinstance(found, (nn.Conv2d, nn.Linear,
                                  nn.ConvTranspose2d)):
            raise AssertionError(f"C.14 Mask R-CNN: two runs part at "
                                 f"{gaps['output']}, not a library kernel")
        log(f"(21e) Mask R-CNN: the first gradient to differ is "
            f"{gaps['output']}, a {type(found).__name__} (a library "
            "kernel)")
    torch.cuda.empty_cache()


def rcnn_phase(dev, card: str, gen: torch.Generator, kernels: dict,
               requests=REQUEST_BATCHES, train_n: int = TRAIN_BATCH,
               steps: int = RCNN_STEPS, small: int = 512,
               step_px: int = 256, others_bs: int = 2,
               panoptic_size: int = PANOPTIC_SIZE, lazy_images: int =
               TRAIN_BATCH, repeat_px: int = 256, rcnn_size=None,
               others_px=None, lazy_px: int = SIZE) -> None:
    """Section 21: LazyConfig and the R-CNN family, full depth and width,
    bf16 over f32 weights from ``SEED``: (a) Mask R-CNN R-50-FPN at 1024
    (:func:`mask_rcnn_paths`), (b) Panoptic FPN at 640
    (:func:`panoptic_paths`), (c) the other 16 LazyConfig files and Faster
    R-CNN (:func:`lazy_others`), (d) the two LazyConfig entry points
    (:func:`lazy_entry_points`), (e) the repeatability of the DCN and Mask
    R-CNN float32 steps (:func:`rcnn_repeat`). Logs the section's
    seconds. The sizes past ``repeat_px`` are a rehearsal's."""
    t0 = time.perf_counter()
    mask_rcnn_paths(dev, card, gen, kernels, requests, train_n, steps,
                    small, step_px, rcnn_size)
    panoptic_paths(dev, card, gen, kernels, requests, train_n, steps,
                   panoptic_size)
    lazy_others(dev, card, gen, others_bs, others_px)
    lazy_entry_points(dev, card, lazy_images, size=lazy_px)
    rcnn_repeat(dev, card, gen, repeat_px)
    log(f"(21) section 21 in {time.perf_counter() - t0:.1f} s on [{card}]")


# ---------------------------------------------------------------------------
# section 22: the library remainder and the closure of the yaml zoo
# ---------------------------------------------------------------------------

LIBRARY_NMS = 1000       # candidates of one image, 80 classes
CLOSURE_ENTRY = {"normalize": "normalize", "nms": "nms",
                 "nms_2048": "nms_rpn", "grid_mask": "grid_mask"}


def library_nms_phase(dev, card: str, gen: torch.Generator,
                      kernels: dict, k: int = LIBRARY_NMS) -> None:
    """(22a) The NMS kernel at [1, k] (80 classes offset as
    ``batched_nms`` offsets them) against its plain version, index-exact:
    the ``nms_single`` entry. Then the library suite on the card against
    the same calls on the CPU: ``nms``, ``batched_nms``,
    ``generalized_batched_nms`` "normal" and WBF's clustering launch K1
    (their launches are the entry's) and are index-exact; cluster-NMS is
    index-exact; soft-NMS keeps the same slots with scores within 1e-5
    relative; WBF's boxes and scores within 1e-5 relative."""
    from yolov7_d2_tpu_torch import ops
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain
    from yolov7_d2_tpu_torch.ops.nms import _class_offset_boxes

    boxes, scores, cls = (t[0] for t in random_nms_inputs(dev, gen, 1, k))
    shifted = _class_offset_boxes(boxes, cls)[None].contiguous()
    one = scores[None].contiguous()
    got = nms_batched(shifted, one, 0.65, 100)
    want = nms_batched_plain(shifted, one, 0.65, 100)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("NMS kernel differs from its plain version at "
                             f"[1, {k}] in {int((got[0] != want[0]).sum())}"
                             " slots")
    entry = {
        "name": "nms_single", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/nms.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_nms.py:34",
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "plain_ms": kernel_ms(lambda: nms_batched_plain(shifted, one, 0.65,
                                                      100),
                              host_ok="nms plain [1, k]"),
        "ms": kernel_ms(lambda: nms_batched(shifted, one, 0.65, 100)),
        "library_ms": None,  # no torchvision: no PyTorch call does NMS
        **bound((shifted.numel() + one.numel()) * 4 + got[1].numel() * 5,
                float(nms_walk_pairs(one, *got, 100)) * 15),
    }

    cpu = [t.cpu() for t in (boxes, scores, cls)]
    opts = dict(iou_threshold=0.65, max_outputs=100, score_threshold=0.05)
    calls = {
        "nms": lambda b, s, c: ops.nms(b, s, **opts),
        "batched_nms": lambda b, s, c: ops.batched_nms(b, s, c, **opts),
        **{f"generalized {t}": functools.partial(
            ops.generalized_batched_nms, nms_type=t, **opts)
           for t in ("normal", "softnms-linear", "softnms-gaussian",
                     "cluster")},
        "weighted_boxes_fusion": lambda b, s, c: ops.weighted_boxes_fusion(
            b, s, 0.55, 100, 0.05),
    }
    build.reset_launches()
    outs = {name: fn(boxes, scores, cls) for name, fn in calls.items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if set(launches) != {"nms"} or launches["nms"] != 4:
        raise AssertionError(f"library NMS launches {launches}")
    entry["launches"] = launches["nms"]
    for name, fn in calls.items():
        got, want = outs[name], fn(*cpu)
        if name == "weighted_boxes_fusion":
            exact, close = (2,), (0, 1)
        elif name.startswith("generalized softnms"):
            exact, close = (1,), (2,)
        else:
            exact, close = tuple(range(len(want))), ()
        for i in exact:
            if not torch.equal(got[i].cpu(), want[i]):
                raise AssertionError(f"{name} output {i} on the card "
                                     "differs from the CPU's")
        for i in close:
            gap = relative_gap_max(got[i].cpu(), want[i])
            if gap > 1e-5:
                raise AssertionError(f"{name} output {i}: {gap:.3g} "
                                     "relative off the CPU's")
    kept = {name: int(outs[name][1 if name != "weighted_boxes_fusion"
                                 else 2].sum()) for name in calls}
    log(f"(22a) nms_single [1, {k}] 80 classes on [{card}]: index-exact "
        f"against its plain version; kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms; the "
        f"library suite on the card as on the CPU, kept {kept}; "
        f"{entry['launches']} K1 launches")
    kernels["nms_single"] = entry


def relative_gap_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    scale = float(want.abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                  1e-30)


def closure_phase(dev, card: str, gen: torch.Generator,
                  kernels: dict) -> None:
    """Section 22: (a) :func:`library_nms_phase`, (b) one train step of
    every yaml (``zoo_step.step_sweep``), the launches counted from 0 and
    added to their kernels' entries. Logs the section's seconds."""
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.zoo_step import step_sweep

    t0 = time.perf_counter()
    library_nms_phase(dev, card, gen, kernels)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    rows = step_sweep(os.path.join(REPO, "configs"), dev,
                      log=lambda msg: log(f"(22b) {msg}"))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for key, n in launches.items():
        kernels[CLOSURE_ENTRY[key]]["launches"] += n
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(rows) != 109:
        raise AssertionError(f"the sweep found {len(rows)} yaml files, "
                             "not 109")
    slow = sorted(rows, key=lambda r: -r["seconds"])[:5]
    log(f"(22b) {len(rows)} of 109 yamls took a step")
    log(f"(22b) the sweep in {time.perf_counter() - t1:.1f} s on [{card}], "
        f"peak memory {peak:.3f} GB; the slowest five: "
        + ", ".join(f"{r['yaml']} {r['seconds']:.2f} s" for r in slow)
        + f"; kernel launches {launches}")
    log(f"(22) section 22 in {time.perf_counter() - t0:.1f} s on [{card}]")



# ---------------------------------------------------------------------------
# section 23: deploy (export, int8, pruning), the C.45 pairings, the feed
# ---------------------------------------------------------------------------

EXPORT_DIR = os.path.join(REPO, "build", "chip_smoke_export")
YOLOX_S_YAML = os.path.join(REPO, "configs", "coco", "yolox_s.yaml")
# the pairings the builders refused before the registry's one table
# (ROADMAP.md C.45): (label, yaml under configs/coco, backbone, features)
C45_PAIRINGS = (
    ("YOLOX ResNet-50", "yolox_s.yaml", "build_resnet_backbone",
     ["res3", "res4", "res5"]),
    ("YOLOX MobileViT", "yolox_s.yaml", "build_mobilevit_backbone",
     ["stage2", "stage3", "stage4"]),
    ("YOLOV7 CSPResNet50d", "yolov7.yaml", "build_cspresnet50d_backbone",
     ["res3", "res4", "res5"]),
    ("d2go DETR Res2Net-50", "detr/d2go/detr_bs16.yaml",
     "build_res2net_backbone", None),
)
# HSV's passes over [16, 640, 640, 3] float32, in and out
HSV_BYTES = TRAIN_BATCH * SIZE * SIZE * 3 * 4 * 2


def run_program_main(argv) -> int:
    """``python3 chip_smoke.py --run-program PROGRAM INPUT OUTPUT DEVICE``:
    in a process of its own, ``load_program(PROGRAM)`` run once on the
    float32 batch saved at INPUT, on DEVICE (the card); saves its outputs,
    the kernels' launches and whether JAX was imported to OUTPUT."""
    program_path, input_path, output_path, device = argv
    sys.path.insert(0, REPO)
    from yolov7_d2_tpu_torch.deploy.export import load_program
    from yolov7_d2_tpu_torch.kernels import build

    x = torch.load(input_path).to(device)
    program = load_program(program_path).module()
    build.reset_launches()
    with torch.inference_mode():
        out = program(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    torch.save({"out": [t.cpu() for t in out],
                "launches": dict(build.LAUNCHES),
                "jax": "jax" in sys.modules}, output_path)
    return 0


def detections_equal(got, want) -> int:
    """The slots where the tuple ``got`` (boxes, scores, classes, valid)
    and ``want``'s ``Detections`` hold the same detection: validity and
    class equal, boxes and scores within 1e-4 of the boxes' largest
    coordinate and of 1."""
    span = max(1.0, float(want.boxes.abs().max()))
    same = (got[3] == want.valid) & (got[2] == want.classes) \
        & ((got[1] - want.scores).abs() <= 1e-4) \
        & ((got[0] - want.boxes).abs() <= 1e-4 * span).all(-1)
    return int(same.sum())


def nms_export_entry(dev, predictor, x, kernels: dict) -> dict:
    """The ``nms_export`` entry: K1 through the custom op at the shapes
    the fused bs-128 program gives it (the tail's top-1024 candidates,
    offset by class), against its plain version."""
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain

    caught = []

    def capture(boxes, scores, thr, max_out):
        caught.append((boxes.clone(), scores.clone(), thr, max_out))
        return nms_batched(boxes, scores, thr, max_out)

    predictor.postprocess(predictor.forward(x), nms=capture)
    boxes, scores, thr, max_out = caught[0]
    op = torch.ops.yolov7_d2_tpu_torch.nms_batched
    got = op(boxes, scores, thr, max_out)
    want = nms_batched_plain(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("(23a) the NMS op differs from its plain "
                             "version on the exported path's inputs")
    return {
        "name": "nms_export", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/nms.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_nms.py:34",
        "launches": 0,
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "ms": kernel_ms(lambda: op(boxes, scores, thr, max_out)),
        "plain_ms": kernel_ms(lambda: nms_batched_plain(boxes, scores, thr,
                                                      max_out),
                              host_ok="nms_export plain"),
        "library_ms": None,  # no torchvision: no PyTorch call does NMS
        **bound((boxes.numel() + scores.numel()) * 4 + got[1].numel() * 5,
                float(nms_walk_pairs(scores, *got, max_out)) * 15),
    }


def export_paths(dev, card: str, gen: torch.Generator, kernels: dict,
                 cli_opts=()) -> None:
    """(23a) YOLOX-s 640 (``configs/coco/yolox_s.yaml``, bf16, the seed's
    weights) exported on a float32 NHWC batch: by
    ``yolov7_d2_tpu_torch.export``'s ``main`` (the CLI's command line,
    ``--fuse-postprocess``, bs 1), loaded and run in a fresh process (its
    K1 launch counted) while this one exports at bs 128 with the tail
    fused and at bs 8 without it, and in float32 (AMP off) at bs 8 both
    ways. Each program, loaded by ``load_program``, against
    ``Predictor``'s model and tail on
    the same float32 batch: float32 raw outputs within 1e-4 of their max
    and ``Detections`` index-equal; bf16 raw outputs within 5e-2 of their
    max, the fused programs' ``Detections`` finite and of their shapes
    (the slots equal to ``Predictor``'s logged); the convolutions of the
    bf16 programs in bfloat16. Logs each program's ms a call beside
    ``Predictor``'s and the export's seconds; the programs' K1 launches
    are the ``nms_export`` entry's. ``cli_opts`` end the CLI's command
    line (config keys and values)."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.deploy.export import (
        conv_dtypes,
        export_inference_fn,
        load_program,
    )
    from yolov7_d2_tpu_torch import export as export_cli
    from yolov7_d2_tpu_torch.export import yolox_tail
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.predictor import Predictor

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    cfg = YoloxConfig()
    predictor = Predictor(cfg, device=dev, seed=SEED)
    batches = {n: letterboxed_batch(n, gen).float().to(dev)
               for n in REQUEST_BATCHES}
    one, few, many = REQUEST_BATCHES
    launches = 0

    # the CLI, then a fresh process that loads and runs its artifact while
    # this one exports the others
    cli_dir = os.path.join(EXPORT_DIR, "cli_bs1")
    t0 = time.perf_counter()
    export_cli.main(["--config-file", YOLOX_S_YAML, "--fuse-postprocess",
                     "--batch", str(one), "--output", cli_dir, *cli_opts])
    cli_s = time.perf_counter() - t0
    with open(os.path.join(cli_dir, "export_meta.json")) as f:
        meta = json.load(f)
    if meta != {"input_shape": [one, SIZE, SIZE, 3],
                "input_dtype": "float32", "layout": "NHWC",
                "postprocess_fused": True}:
        raise AssertionError(f"(23a) export_meta.json: {meta}")
    torch.save(batches[one].cpu(), os.path.join(EXPORT_DIR, "bs1.pt"))
    t_fresh = time.perf_counter()
    fresh_proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--run-program",
         os.path.join(cli_dir, "model.pt2"),
         os.path.join(EXPORT_DIR, "bs1.pt"),
         os.path.join(EXPORT_DIR, "bs1_out.pt"), str(dev)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    f32cfg = dataclasses.replace(cfg, amp=False)
    f32 = Predictor(f32cfg, device=dev, seed=SEED)
    programs = [(f"bf16 bs {one} fused (the CLI's)", cfg, predictor, one,
                 True, os.path.join(cli_dir, "model.pt2"), None)]
    for label, c, pred, bs, fused in (
            (f"bf16 bs {many} fused", cfg, predictor, many, True),
            (f"bf16 bs {few} raw", cfg, predictor, few, False),
            (f"float32 bs {few} raw", f32cfg, f32, few, False),
            (f"float32 bs {few} fused", f32cfg, f32, few, True)):
        t0 = time.perf_counter()
        paths = export_inference_fn(
            pred.model, (bs, SIZE, SIZE, 3),
            os.path.join(EXPORT_DIR, label.replace(" ", "_")),
            yolox_tail(c) if fused else None)
        programs.append((label, c, pred, bs, fused, paths["program"],
                         time.perf_counter() - t0))
    try:
        _, err = fresh_proc.communicate(timeout=600)
    finally:
        fresh_proc.kill()
    fresh_s = time.perf_counter() - t_fresh
    if fresh_proc.returncode != 0:
        raise AssertionError(f"(23a) the fresh process failed: {err[-3000:]}")
    fresh = torch.load(os.path.join(EXPORT_DIR, "bs1_out.pt"))
    if fresh["launches"] != {"nms": 1} or fresh["jax"]:
        raise AssertionError(f"(23a) the fresh process: launches "
                             f"{fresh['launches']}, jax {fresh['jax']}")
    launches += 1
    want1 = predictor.postprocess(predictor.forward(batches[one]))
    fresh_out = [t.to(dev) for t in fresh["out"]]
    if not torch.isfinite(fresh_out[0][fresh_out[3]]).all():
        raise AssertionError("(23a) the CLI artifact gave non-finite boxes")
    log(f"(23a) export CLI (bs {one}, tail fused) in {cli_s:.1f} s; a "
        f"fresh process loaded and ran it in {fresh_s:.1f} s (beside the "
        f"exports below): K1 launches {fresh['launches']}, jax imported "
        f"{fresh['jax']}; {detections_equal(fresh_out, want1)} of "
        f"{want1.valid.numel()} slots equal Predictor's (bf16)")
    for label, c, pred, bs, fused, path, export_s in programs:
        loaded = load_program(path)
        dtypes = conv_dtypes(loaded)
        want_dtype = "bfloat16" if c.amp else "float32"
        if list(dtypes) != [want_dtype]:
            raise AssertionError(f"(23a) {label}: convolutions {dtypes}")
        program = loaded.module()
        x = batches[bs]
        torch.cuda.synchronize()
        build.reset_launches()
        with torch.inference_mode():
            got = program(x)
        torch.cuda.synchronize()
        got_l = dict(build.LAUNCHES)
        if got_l != ({"nms": 1} if fused else {}):
            raise AssertionError(f"(23a) {label}: launches {got_l}")
        launches += got_l.get("nms", 0)
        head = pred.forward(x)
        if fused:
            want = pred.postprocess(head)
            equal = detections_equal(got, want)
            if c.amp:
                check_detections(type(want)(*got), bs, c, label)
            elif equal != want.valid.numel():
                raise AssertionError(f"(23a) {label}: {equal} of "
                                     f"{want.valid.numel()} slots equal")
            what = f"{equal} of {want.valid.numel()} slots equal"
        else:
            scale = float(head["outputs"].float().abs().max())
            err = float((got["outputs"].float()
                         - head["outputs"].float()).abs().max())
            tol = 5e-2 if c.amp else 1e-4
            if err > tol * scale:
                raise AssertionError(f"(23a) {label}: raw outputs {err:.3g}"
                                     f" off, above {tol} of {scale:.4g}")
            what = f"raw outputs {err:.3g} of max {scale:.4g} off"

        def ref():
            out = pred.forward(x)
            return pred.postprocess(out) if fused else out

        with torch.inference_mode():
            prog_ms = cuda_ms(lambda: program(x))
        ref_ms = cuda_ms(ref)
        log(f"(23a) {label} on [{card}]: {what}; convolutions {dtypes}; "
            f"program {prog_ms:.3f} ms a call, Predictor "
            f"{'model + tail' if fused else 'model'} {ref_ms:.3f} ms"
            + ("" if export_s is None else
               f"; exported, saved in {export_s:.1f} s"))
        del loaded, program, got, head
    entry = nms_export_entry(dev, predictor, batches[many], kernels)
    entry["launches"] = launches
    kernels["nms_export"] = entry
    log(f"(23a) nms_export [{card}]: K1 through the custom op on "
        f"[{many}, {cfg.pre_nms_topk}], index-exact; kernel "
        f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms; {launches} launches from the "
        "programs")
    del predictor, f32, batches
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def quant_prune_paths(dev, card: str, gen: torch.Generator,
                      kernels: dict) -> None:
    """(23b) YOLOX-s's weights quantized to int8 on the card: each element
    within its half scale of the weight; dequantized to bf16 and served at
    bs 128 (finite ``Detections``); ``l1_filter_prune`` at 0.5 and served,
    the sparsity report logged."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.deploy import prune, quantize
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.predictor import Predictor

    cfg = YoloxConfig()
    predictor = Predictor(cfg, device=dev, seed=SEED)
    model = predictor.model
    weights = {k: v.detach().clone() for k, v in model.named_parameters()}
    t0 = time.perf_counter()
    q, scales = quantize.quantize_weights_int8(model)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    worst, count, n_int8 = -0.5, 0, 0
    for name, s in scales.items():
        if s is None:
            continue
        # how far past its half scale an element's round trip lands (in
        # scales; -0.5 is exact)
        gap = ((q[name].float() * s - weights[name]).abs() - s / 2) / s
        worst = max(worst, float(gap.max()))
        count += 1
        n_int8 += q[name].numel()
    if worst > 1e-5:
        raise AssertionError(f"(23b) an int8 weight is {worst:.3g} of a "
                             "scale beyond its half scale")
    req = letterboxed_batch(BATCH, gen).to(dev)
    model.load_state_dict(quantize.dequantize_weights(q, scales), strict=False)
    build.reset_launches()
    summary_q = check_detections(predictor.predict_batch(req), BATCH, cfg,
                                 "(23b) int8 weights")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    model.load_state_dict(weights, strict=False)
    pruned, _ = prune.l1_filter_prune(model, 0.5)
    model.load_state_dict(pruned, strict=False)
    summary_p = check_detections(predictor.predict_batch(req), BATCH, cfg,
                                 "(23b) pruned weights")
    report = prune.sparsity_report(model)
    for k in ("normalize", "nms"):
        kernels[k]["launches"] += launches.get(k, 0)
    layers = sorted((v, k) for k, v in report.items() if k != "global")
    log(f"(23b) int8 on [{card}]: {count} tensors, {n_int8} weights "
        f"quantized in {q_s:.2f} s, every element within its half scale "
        f"(worst {worst:.2e} of a scale beyond it); bf16 dequantized, bs "
        f"{BATCH}: {summary_q}, launches {launches}; l1_filter_prune 0.5: "
        f"bs {BATCH} {summary_p}; sparsity global {report['global']:.4f}, "
        f"layers {layers[0][0]:.3f} ({layers[0][1]}) to {layers[-1][0]:.3f} "
        f"({layers[-1][1]})")
    del predictor, model, weights, q, scales, pruned
    torch.cuda.empty_cache()


def c45_cfg(yaml: str, backbone: str, features):
    """The config dataclass of ``configs/coco/<yaml>`` on ``backbone``
    (``MODEL.YOLO.IN_FEATURES`` its three outputs where given), through
    the CfgNode, as a user's config reaches the registry's builder."""
    from yolov7_d2_tpu_torch.config.defaults import get_cfg
    from yolov7_d2_tpu_torch.engine import config_from_cfg

    node = get_cfg()
    node.merge_from_file(os.path.join(REPO, "configs", "coco", yaml))
    node.MODEL.BACKBONE.NAME = backbone
    if features is not None:
        node.MODEL.YOLO.IN_FEATURES = features
    return config_from_cfg(node)


def c45_paths(dev, card: str, gen: torch.Generator, kernels: dict,
              bs: int = 8, train_n: int = TRAIN_BATCH, size=None) -> None:
    """(23c) Each of :data:`C45_PAIRINGS` at full width and its yaml's size:
    one request of ``bs`` images through the family's tail (K2 at the
    head; K1 in the YOLO tails) and one ``build_system`` step of
    ``train_n`` images (YOLOX and YOLOV7 in ``make_packed_photo_step``):
    finite losses, launches added to ``kernels``. ``size`` replaces the
    yamls' input size."""
    from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.predictor import Predictor

    for label, yaml, backbone, features in C45_PAIRINGS:
        t0 = time.perf_counter()
        cfg = c45_cfg(yaml, backbone, features)
        if size is not None:
            cfg = dataclasses.replace(cfg, input_size=(size, size))
        px = cfg.input_size[0]
        model, state, train_step, _ = build_system(cfg, device=dev,
                                                   seed=SEED)
        req = letterboxed_batch(bs, gen, px).to(dev)
        build.reset_launches()
        if cfg.meta_architecture == "YOLOX":
            dets = Predictor(cfg, device=dev, model=model.eval()
                             ).predict_batch(req)
        elif cfg.meta_architecture == "DetrD2go":
            _, dets = detr_serve(model.eval(), cfg, req)
        else:
            _, dets = anchor_serve(model.eval(), cfg, req)
        summary = check_detections(dets, bs, cfg, label)
        torch.cuda.synchronize()
        serve = dict(build.LAUNCHES)
        if cfg.meta_architecture == "DetrD2go":
            batch = detr_batch(train_n, gen, dev, px)
            step = train_step
        else:
            batch = {k: v.to(dev) for k, v in train_batch(
                train_n, gen, px).items()}
            step = make_packed_photo_step(cfg, train_step, seed=SEED)
        model.train()
        build.reset_launches()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        train = dict(build.LAUNCHES)
        bad = [k for k, v in m.items() if "loss" in k
               and not math.isfinite(float(v))]
        if bad or not math.isfinite(float(m["total_loss"])):
            raise AssertionError(f"(23c) {label}: non-finite {bad}")
        needs = ("normalize",) + (() if cfg.meta_architecture == "DetrD2go"
                                  else ("nms",))
        for kernel in needs:
            if serve.get(kernel, 0) < 1:
                raise AssertionError(f"(23c) {label} serving never launched "
                                     f"{kernel}")
        entry = {"YOLOX": "normalize", "YOLOV7": "normalize"}.get(
            cfg.meta_architecture, "normalize_detr")
        kernels[entry]["launches"] += serve.get("normalize", 0) + train.get(
            "normalize", 0)
        kernels["nms"]["launches"] += serve.get("nms", 0)
        log(f"(23c) {label} ({type(model.backbone).__name__}, "
            f"{sum(p.numel() for p in model.parameters())} parameters) at "
            f"{px} on [{card}]: bs {bs} {summary}, launches {serve}; one "
            f"step of {train_n}: total loss {float(m['total_loss']):.4f}, "
            f"launches {train}; {time.perf_counter() - t0:.1f} s")
        del model, state, train_step, step, batch
        torch.cuda.empty_cache()


def feed_paths(dev, card: str, gen: torch.Generator, kernels: dict,
               images: int = CLI_IMAGES, steps: int = 3) -> None:
    """(23d) The feed: YOLOX-s's host mosaic (``YOLOXDatasetMapper`` at
    640) through ``MultiProcessDataLoader`` with 4 spawned workers
    (``MapperFactory``) against the threaded ``DataLoader``, img/s over 10
    batches of 16 (after the first, or after 2 a worker); ``steps`` steps
    of YOLOX-s 640 with the HSV distortion on, MixUp on with GridMask (its
    float32 instance), MixUp off, and MixUp off with GridMask (float32
    again: HSV makes the image float), the photometric stage timed alone
    beside HSV's bytes bound; then steps under ``MultiScaleHook`` over two
    sizes, switching every 2 steps (the wrapped mapper maps each batch in
    this process)."""
    import numpy as np

    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.config.defaults import get_cfg
    from yolov7_d2_tpu_torch.data import mappers
    from yolov7_d2_tpu_torch.data.coco import load_coco_json
    from yolov7_d2_tpu_torch.data.device_aug import (
        DevicePhotometric,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.data.loader import (
        build_detection_train_loader,
        stack_batch,
    )
    from yolov7_d2_tpu_torch.data.mp_loader import MultiProcessDataLoader
    from yolov7_d2_tpu_torch.data.multiscale import (
        MultiScaleMapperWrapper,
        size_for_step,
    )
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.train.trainer import MultiScaleHook

    work = os.path.join(REPO, "build", "chip_smoke_feed")
    shutil.rmtree(work, ignore_errors=True)
    js, img_dir = write_mini_coco(work, n=images)
    records = load_coco_json(js, img_dir)
    node = get_cfg()
    node.merge_from_file(YOLOX_S_YAML)
    node.DATALOADER.NUM_WORKERS = 4
    try:
        threads = loader_rate(build_detection_train_loader(
            node, records, mappers.YOLOXDatasetMapper(node, seed=0),
            batch_size=TRAIN_BATCH))
        rates = {}
        for workers in (4,):
            t0 = time.perf_counter()
            loader = MultiProcessDataLoader(
                records, mappers.MapperFactory(mappers.YOLOXDatasetMapper,
                                               node),
                TRAIN_BATCH, num_workers=workers, seed=SEED)
            # every worker's first samples come before the timed batches:
            # a spawned worker starts in 10-15 s (its imports)
            rates[workers] = (loader_rate(loader, warm=2 * workers),
                              time.perf_counter() - t0)
        log(f"(23d) YOLOX-s mosaic at 640 on [{card}], os.cpu_count() "
            f"{os.cpu_count()}: threaded DataLoader (4 threads) "
            f"{threads:.1f} img/s; MultiProcessDataLoader "
            + ", ".join(f"{w} worker{'s' * (w > 1)} {r:.1f} img/s ({s:.1f} "
                        "s with the spawn)" for w, (r, s) in rates.items())
            + f" (10 batches of {TRAIN_BATCH} after the first, after 2 a "
            "worker for the process loaders, host clock)")

        # the HSV distortion in the photometric stage
        base = dataclasses.replace(YoloxConfig(), distortion=True)
        _, state, train_step = build_yolox_system(base, device=dev,
                                                  seed=SEED)
        batches = [{k: v.to(dev) for k, v in train_batch(
            TRAIN_BATCH, gen).items()} for _ in range(steps)]
        for label, mixup, grid in (("MixUp on, GridMask", True, True),
                                   ("MixUp off", False, False),
                                   ("MixUp off, GridMask", False, True)):
            cfg = dataclasses.replace(base, mixup=mixup, grid_mask=grid,
                                      grid_mask_prob=1.0)
            step = make_packed_photo_step(cfg, train_step, seed=SEED)
            build.reset_launches()
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append(m)
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            check_yolox_metrics(metrics, f"(23d) HSV, {label}")
            want = {"grid_mask": steps} if grid else {}
            if not mixup:
                want["normalize"] = 0
            if {k: launches.get(k, 0) for k in want} != want:
                raise AssertionError(f"(23d) HSV, {label}: launches "
                                     f"{launches}")
            if grid:
                kernels["grid_mask"]["launches"] += launches["grid_mask"]
            aug = DevicePhotometric(cfg)
            draws = aug.draw(torch.Generator().manual_seed(SEED),
                             TRAIN_BATCH, SIZE, SIZE)
            out = aug.apply(batches[0], draws)
            if out["image"].dtype != torch.float32:
                raise AssertionError(f"(23d) HSV, {label}: "
                                     f"{out['image'].dtype} image")
            stage_ms = cuda_ms(lambda: aug.apply(batches[0], draws))
            log(f"(23d) HSV on, {label}, on [{card}]: {steps} steps of "
                f"{TRAIN_BATCH}, total loss "
                f"{float(metrics[-1]['total_loss']):.4f}, launches "
                f"{launches}; the photometric stage alone {stage_ms:.3f} ms "
                f"(HSV's bytes bound {HSV_BYTES / HBM_BYTES_PER_S * 1e3:.4f}"
                f" ms: {HSV_BYTES / 1e6:.0f} MB in and out)")

        # MultiScaleHook: two sizes, a new draw every 2 steps
        small = SIZE * 9 // 10 // 32 * 32
        sizes = [(SIZE, SIZE), (small, small)]
        seed = next(sd for sd in range(SEED, SEED + 100) if len({
            size_for_step(i, sizes, 2, sd) for i in range(6)}) == 2)
        wrapper = MultiScaleMapperWrapper(
            mappers.YOLOXDatasetMapper(node, seed=0), sizes, interval=2,
            seed=seed)
        hook = MultiScaleHook(wrapper)
        step = make_packed_photo_step(base, train_step, seed=SEED)
        seen = []
        rng = np.random.default_rng(SEED)
        for i in range(6):
            hook.after_step(types_namespace(iter=i))
            picks = rng.choice(len(records), TRAIN_BATCH, replace=False)
            batch = stack_batch([wrapper(records[int(j)]) for j in picks])
            seen.append(tuple(batch["image"].shape[1:3]))
            state, m = step(state, {k: torch.from_numpy(batch[k]).to(dev)
                                    for k in ("image", "gt_boxes",
                                              "gt_classes", "gt_valid")})
            check_yolox_metrics([m], f"(23d) multi-scale step {i}")
        if set(seen) != set(sizes) or any(
                seen[i] != size_for_step(i, sizes, 2, seed)
                for i in range(6)):
            raise AssertionError(f"(23d) multi-scale sizes {seen}")
        log(f"(23d) MultiScaleHook on [{card}]: 6 steps of {TRAIN_BATCH} at "
            f"sizes {seen} (schedule seed {seed}), finite losses")
        del state, train_step, step, batches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def types_namespace(**storage):
    """A stand-in trainer whose ``storage`` has the given fields."""
    import types

    return types.SimpleNamespace(storage=types.SimpleNamespace(**storage))


def deploy_feed_phase(dev, card: str, gen: torch.Generator,
                      kernels: dict) -> None:
    """Section 23: (a) :func:`export_paths`, (b) :func:`quant_prune_paths`,
    (c) :func:`c45_paths`, (d) :func:`feed_paths`, each subsection's end
    logged."""
    t0 = time.perf_counter()
    for label, fn in (("a", export_paths), ("b", quant_prune_paths),
                      ("c", c45_paths), ("d", feed_paths)):
        fn(dev, card, gen, kernels)
        log(f"(23{label}) done {time.perf_counter() - t0:.1f} s into "
            "section 23")


# ---------------------------------------------------------------------------
# section 24: tensor parallelism over the model axis of a (data, model) grid
# ---------------------------------------------------------------------------

TP_MIN_FEATURES = 128  # the JAX dryrun's (__graft_entry__.py:95)
TP_F32_STEPS = 2
TP_PHOTO_STEPS = 3
TP_PHOTO_BATCH = 8  # images a data rank in (b)


def grid_checks(label: str, ranks: list, shape: tuple) -> None:
    """The shard checks of a grid run (``train_steps`` records in rank
    order): each sharded parameter, its optimizer state and its EMA of O /
    model rows, the shards bitwise equal across the data ranks and apart
    across the model ranks, and the gathered state (so every replicated
    parameter) bitwise equal on every rank."""
    data, model = shape
    names = set(ranks[0]["shards"])
    if not names:
        raise AssertionError(f"{label} no parameter is sharded")
    whole = ranks[0]["model"]
    for r, rec in enumerate(ranks):
        if set(rec["shards"]) != names:
            raise AssertionError(f"{label} rank {r} shards other parameters")
        for name in names:
            rows = whole[name].shape[0] // model
            got = {rec["shards"][name].shape[0],
                   rec["ema_shards"][name].shape[0],
                   *(s[0] for s in rec["opt_shapes"][name])}
            if got != {rows}:
                raise AssertionError(f"{label} rank {r} {name}: rows {got}, "
                                     f"not {rows}")
            same_m = ranks[r % model]["shards"][name]
            if not torch.equal(rec["shards"][name], same_m):
                raise AssertionError(f"{label} {name}: data ranks hold other "
                                     "shards")
        for key in ("model", "ema"):
            for name, v in ranks[0][key].items():
                if not torch.equal(rec[key][name], v):
                    raise AssertionError(f"{label} rank {r}: gathered {key} "
                                         f"{name} differs from rank 0's")
    for name in names:
        if torch.equal(ranks[0]["shards"][name], ranks[1]["shards"][name]):
            raise AssertionError(f"{label} {name}: model ranks 0 and 1 hold "
                                 "the same shard")


def tensor_parallel_phase(dev, card: str, cfg, kernels: dict,
                          shape: tuple = (2, 2),
                          backend: str = "gloo") -> None:
    """Section 24: YOLOX-s 640 at full width and depth on a (data, model)
    grid of ``shape`` (``parallel.mesh``: the parameters with 128 or more
    output features sharded over the model axis, column-parallel; the JAX
    dryrun's strategy), in one spawn: gloo ranks all on ``dev``, or over
    NCCL one card a rank ((c), ``nccl_main``).

    (a) The float32 step, TF32 off, 2 images a data rank, 2 steps, each
    held against one process from the ranks' gathered weights and under
    the ranks' prefilter (as section 10 (a)): the foreground count equal,
    the summed loss shares and the gradient norm within 1e-3 relative, and
    :func:`grid_checks`. Logs the parameter elements a rank holds against
    one process and the CUDA kernel launches of a rank's step 1.

    (b) 3 bf16 steps of ``make_packed_photo_step`` (MixUp and GridMask on)
    on 8 uint8 images a data rank: finite losses and foreground, weights
    moved, :func:`grid_checks`, and the images each model took equal
    across the model ranks of a data slice and apart across data slices
    (the model ranks drew alike). Its GridMask launches (K3, counted in the
    ranks) join the ``grid_mask`` entry."""
    from yolov7_d2_tpu_torch.engine import (
        build_yolox_system,
        resolve_simota_prefilter,
    )
    from yolov7_d2_tpu_torch.parallel.dryrun import in_turn, train_steps
    from yolov7_d2_tpu_torch.parallel.launch import launch

    label = "(24a)" if backend == "gloo" else "(24c)"
    data, model = shape
    world = data * model
    fcfg = dataclasses.replace(cfg, amp=False)
    pcfg = dataclasses.replace(cfg, grid_mask=True, mixup=True)
    gen = torch.Generator().manual_seed(SEED + 24)
    f32_batches = [train_batch(2 * data, gen) for _ in range(TP_F32_STEPS)]
    photo_batches = [train_batch(TP_PHOTO_BATCH * data, gen)
                     for _ in range(TP_PHOTO_STEPS)]
    out = os.path.join(REPO, "build", "chip_smoke_grid")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    where = str(dev) if backend == "gloo" else dev.type
    common = (SEED, None)
    calls = [
        (train_steps, (out, fcfg, f32_batches, where, *common,
                       1 if dev.type == "cuda" else None, True, True, shape,
                       TP_MIN_FEATURES, False, "a")),
        (train_steps, (out, pcfg, photo_batches, where, *common, None,
                       False, True, shape, TP_MIN_FEATURES, True, "b")),
    ]
    # the ranks start with torch's defaults: TF32 off for them as here
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    t0 = time.perf_counter()
    try:
        launch(in_turn, world, args=(calls,), backend=backend)
    finally:
        del os.environ["NVIDIA_TF32_OVERRIDE"]
    wall = time.perf_counter() - t0
    runs = {tag: [torch.load(os.path.join(out, f"{tag}{r}.pt"),
                             weights_only=True) for r in range(world)]
            for tag in ("a", "b")}
    shutil.rmtree(out, ignore_errors=True)

    # ---- (a) float32 against one process
    ranks = runs["a"]
    firsts = ranks[::model]  # model rank 0 of each data slice
    k = resolve_simota_prefilter(fcfg)
    _, state, step = build_yolox_system(fcfg, device=dev, seed=SEED)
    from yolov7_d2_tpu_torch.utils.profiling import count_cuda_launches

    launches_one = None
    for i, batch in enumerate(f32_batches):
        batch = {key: v.to(dev) for key, v in batch.items()}
        state.model.load_state_dict(ranks[0]["weights"][i])
        state.step = i
        ranked = torch.cat([rec["outputs"][i][..., 4] for rec in firsts])
        with prefilter_ranked_by(ranked.to(dev)):
            if i == 1 and dev.type == "cuda":
                (state, m), launches_one = count_cuda_launches(
                    lambda: step(state, batch))
            else:
                state, m = step(state, batch)
        want = {key: float(v) for key, v in m.items()}
        ms = [rec["metrics"][i] for rec in ranks]
        # the model ranks of a data slice compute the same loss share, up to
        # the library's sum order
        apart = max(relative_gap(ms[r]["total_loss"],
                                 ms[r - r % model]["total_loss"])
                    for r in range(world))
        loss = sum(rec["metrics"][i]["total_loss"] for rec in firsts)
        gaps = {key: relative_gap(got, want[key]) for key, got in (
            ("total_loss", loss), ("grad_norm", ms[0]["grad_norm"]))}
        log(f"{label} step {i}: grid {shape} / one process: total_loss "
            f"{loss:.6g} / {want['total_loss']:.6g} "
            f"({gaps['total_loss']:.2e}), grad_norm {ms[0]['grad_norm']:.6g}"
            f" / {want['grad_norm']:.6g} ({gaps['grad_norm']:.2e}), num_fg "
            f"{ms[0]['num_fg']:.0f} / {want['num_fg']:.0f}; the model ranks' "
            f"loss shares {apart:.2e} apart")
        if any(m_["num_fg"] != want["num_fg"] for m_ in ms):
            raise AssertionError(f"{label} step {i}: fg counts differ")
        if len({m_["grad_norm"] for m_ in ms}) != 1:
            raise AssertionError(f"{label} step {i}: the ranks' gradient "
                                 "norms differ")
        for key, gap in gaps.items():
            if gap > 1e-3:
                raise AssertionError(f"{label} step {i}: {key} off by "
                                     f"{gap:.2e} relative to one process, "
                                     "above 1e-3")
    del state, step
    grid_checks(label, ranks, shape)
    if any(rec["step"] != TP_F32_STEPS for rec in ranks):
        raise AssertionError(f"{label} the ranks took other steps")
    held, whole = ranks[0]["param_elements"]
    n_sharded = len(ranks[0]["shards"])
    sharded_elems = sum(ranks[0]["model"][n].numel()
                        for n in ranks[0]["shards"])
    launches_rank = ranks[0]["metrics"][1].get("launches")
    host = ("on one card, host-paced over gloo and not a multi-GPU rate"
            if backend == "gloo" else "over NCCL, one card a rank")
    log(f"{label} grid {shape} of {world} {backend} ranks [{card}]: "
        f"{n_sharded} parameters ({sharded_elems} of {whole} elements) "
        f"sharded at {TP_MIN_FEATURES}; a rank holds {held} parameter "
        f"elements, {held / whole:.4f} of one process's (and as much of its "
        f"momentum and EMA); gathered state bitwise equal on every rank, "
        f"shards equal across data ranks and apart across model ranks; CUDA "
        f"kernel launches in step 1: one process {launches_one} "
        f"({2 * data} images), a rank {launches_rank} (2 images); {wall:.2f}"
        f" s for the spawn, (a) and (b) and the ranks' start-up, {host}")

    # ---- (b) bf16 photometric steps
    label_b = "(24b)" if backend == "gloo" else "(24c)"
    ranks = runs["b"]
    for r, rec in enumerate(ranks):
        for i, m_ in enumerate(rec["metrics"]):
            for key in ("total_loss", "loss_iou", "loss_obj", "loss_cls",
                        "grad_norm"):
                if not math.isfinite(m_[key]):
                    raise AssertionError(f"{label_b} rank {r} step {i}: "
                                         f"{key} {m_[key]}")
            if not m_["num_fg"] > 1:
                raise AssertionError(f"{label_b} rank {r} step {i}: no "
                                     "foreground anchor")
        same = ranks[r - r % model]["inputs"]
        if rec["inputs"] != same:
            raise AssertionError(f"{label_b} rank {r}: the model took other "
                                 "images than its data slice's model rank 0")
    if data > 1 and ranks[0]["inputs"] == ranks[model]["inputs"]:
        raise AssertionError(f"{label_b} two data slices took the same "
                             "images")
    first = ranks[0]["weights"][0]
    moved = sum(not torch.equal(first[n], v)
                for n, v in ranks[0]["model"].items())
    if moved == 0:
        raise AssertionError(f"{label_b} the steps moved no tensor")
    grid_checks(label_b, ranks, shape)
    masks = sum(rec["kernel_launches"].get("grid_mask", 0) for rec in ranks)
    if masks < world * TP_PHOTO_STEPS:
        raise AssertionError(f"{label_b} grid_mask launched {masks} times "
                             f"in {world} ranks x {TP_PHOTO_STEPS} steps")
    masked = sum(m_["grid_masked"] for rec in ranks for m_ in rec["metrics"])
    kernels["grid_mask"]["launches"] += masks
    log(f"{label_b} grid {shape} [{card}], bf16, {TP_PHOTO_BATCH} images a "
        f"data rank, MixUp and GridMask: {TP_PHOTO_STEPS} steps finite; "
        f"{moved} state tensors moved; the model ranks of each data slice "
        f"took bitwise equal images and hold bitwise equal replicated "
        f"parameters; grid_mask launched {masks} times over the ranks "
        f"({masked:.0f} images masked); total_loss by step on rank 0: "
        + ", ".join(f"{m_['total_loss']:.4f}" for m_ in ranks[0]["metrics"]))


def grid_nccl_phase(card: str, cfg) -> None:
    """(24c) :func:`tensor_parallel_phase` over NCCL, one card a rank: a
    (2, 2) grid on 4 or more visible cards, (1, 2) on 2-3; logged as
    skipped on one."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"(24c) NCCL grid: skipped, {n} CUDA card visible (needs 2)")
        return
    shape = (2, 2) if n >= 4 else (1, 2)
    t0 = time.perf_counter()
    tensor_parallel_phase(torch.device("cuda", 0), card, cfg,
                          {"grid_mask": {"launches": 0}}, shape=shape,
                          backend="nccl")
    log(f"(24c) NCCL grid {shape} [{card}] x{n}: "
        f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# section 25: the device geometry feed (DeviceAug) and rematerialization
# ---------------------------------------------------------------------------

AUG_IMAGE_TOL = 1e-3 * 255  # DeviceAug on the card against the CPU
AUG_PIXEL_SHARE = 0.999     # of the pixels within it (seams may flip)
AUG_BOX_TOL = 1e-3          # px
REMAT_STEPS = 3             # one compared, two timed


def device_tiles(n: int, gen: torch.Generator, size: int = SIZE,
                 slots: int = 100) -> dict:
    """A batch of tiles as ``TileDatasetMapper`` gives them (host
    tensors): images of 240-640 px a side, letterboxed to fit ``size`` at
    the top left, gray elsewhere (noise inside), ``orig_hw`` their sizes,
    1-20 boxes of 8 px to half the image inside each, in ``slots``
    valid-first slots."""
    orig = (240 + torch.randint(0, 401, (n, 2), generator=gen)).float()
    scale = torch.minimum(size / orig[:, 0], size / orig[:, 1])
    pre = (orig * scale[:, None]).round()
    ys = torch.arange(size)[None, :, None]
    xs = torch.arange(size)[None, None, :]
    inside = (ys < pre[:, 0, None, None]) & (xs < pre[:, 1, None, None])
    noise = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                          dtype=torch.uint8)
    image = torch.where(inside[..., None], noise, torch.tensor(
        114, dtype=torch.uint8))
    count = torch.randint(1, 21, (n, 1), generator=gen)
    valid = torch.arange(slots)[None] < count
    span = pre.flip(-1)[:, None, :]                     # (w, h)
    xy = torch.rand((n, slots, 2), generator=gen) * (span - 8)
    wh = 8 + torch.rand((n, slots, 2), generator=gen) * (span / 2 - 8)
    boxes = torch.cat([xy, torch.minimum(xy + wh, span)], -1)
    return {"image": image, "gt_boxes": boxes * valid[..., None],
            "gt_classes": (torch.randint(0, 80, (n, slots), generator=gen)
                           * valid).to(torch.int32),
            "gt_valid": valid, "orig_hw": orig}


def remat_record(build_fn, batch, steps: int = REMAT_STEPS) -> dict:
    """The first step of ``build_fn()``'s fresh state on ``batch``: its
    metrics, every gradient, the BatchNorm buffers after it and the peak
    of ``max_memory_allocated``; then the host-clock ms a step of the next
    ``steps - 1``."""
    state, step = build_fn()
    grads = {}
    update = state.optimizer.step

    def grab():
        grads.update({n: p.grad.clone()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
        update()

    state.optimizer.step = grab
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    buffers = {k: v.clone() for k, v in state.model.state_dict().items()
               if "running_" in k or "num_batches_tracked" in k}
    state.optimizer.step = update
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "buffers": buffers, "peak_gb": peak, "ms": ms}


def remat_gaps(got: dict, want: dict, what: str) -> str:
    """Checks a remat step against the step without: the loss within
    1e-6 relative, every gradient within 1e-5 of its largest magnitude,
    the BatchNorm buffers bitwise; returns how far apart they are."""
    loss_gap = relative_gap(got["metrics"]["total_loss"],
                            want["metrics"]["total_loss"])
    unequal, worst = 0, 0.0
    for k, w in want["grads"].items():
        g = got["grads"][k]
        if not torch.equal(g, w):
            unequal += 1
            worst = max(worst, float((g - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
    bn_equal = all(torch.equal(got["buffers"][k], v)
                   for k, v in want["buffers"].items())
    if sorted(got["grads"]) != sorted(want["grads"]) or loss_gap > 1e-6 \
            or worst > 1e-5 or not bn_equal:
        raise AssertionError(f"(25c) {what}: remat parts from the step "
                             f"without: loss {loss_gap:.3g}, gradients "
                             f"{worst:.3g}, BN buffers equal {bn_equal}")
    return (f"loss {'bitwise' if loss_gap == 0 else f'{loss_gap:.3g}'}, "
            f"{len(want['grads']) - unequal} of {len(want['grads'])} "
            f"gradients bitwise (worst {worst:.3g} of its max), "
            f"{len(want['buffers'])} BN buffers bitwise")


def device_aug_remat_phase(dev, card: str, gen: torch.Generator,
                           kernels: dict) -> None:
    """Section 25. (a) ``DeviceAug`` on [16, 640, 640, 3] tiles -> 640 with
    MixUp, HSV and GridMask: ms by CUDA events (10 calls after 3) beside
    the packed photometric stage's on the same card, and the card's output
    against the port's CPU output on the same draws. (b) 3 bf16 steps of
    YOLOX-s 640 through ``make_device_aug_step`` with DISABLE_AT_ITER 2:
    finite, weights moved, K3 at steps 0-1 and the uint8 passthrough
    through K2 at step 2; K3's and K2's launches added to their entries.
    (c) float32 steps with remat and without from the same weights and
    batch, cuDNN deterministic (DETR also SDPA's math backend; C.14):
    YOLOX-s of 16 at 640 (``TPU.REMAT``), DETR R-50 of 8 at 800, dropout
    0.1, with ``MODEL.DETR.REMAT`` and with ``TPU.REMAT``: loss, gradients
    and BN buffers, and each one's peak memory and step ms."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.device_aug import (
        DeviceAug,
        DevicePhotometric,
        make_device_aug_step,
    )
    from yolov7_d2_tpu_torch.engine import build_system, build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build

    t0 = time.perf_counter()
    n = TRAIN_BATCH
    # ---- (a) DeviceAug alone, the card against the CPU
    cfg = dataclasses.replace(YoloxConfig(), distortion=True, grid_mask=True)
    aug = DeviceAug(cfg)
    host = device_tiles(n, gen)
    tiles = {k: v.to(dev) for k, v in host.items()}
    draws = aug.draw(torch.Generator().manual_seed(SEED), n)
    ref = aug.apply(host, draws)
    on_card = draws.to(dev)
    got = aug.apply(tiles, on_card)
    torch.cuda.synchronize()
    px = (got["image"].cpu() - ref["image"]).abs().amax(-1)
    off = int((px > AUG_IMAGE_TOL).sum())
    box_err = float((got["gt_boxes"].cpu() - ref["gt_boxes"]).abs().max())
    same = (torch.equal(got["gt_valid"].cpu(), ref["gt_valid"])
            and torch.equal(got["gt_classes"].cpu(), ref["gt_classes"]))
    log(f"(25a) DeviceAug {tuple(host['image'].shape)} -> {cfg.input_size}, "
        f"MixUp, HSV, GridMask: card against the CPU on the same draws: "
        f"image max err {float(px.max()):.4g}, {off} of {px.numel()} pixels "
        f"past {AUG_IMAGE_TOL:.3g}; boxes max err {box_err:.3g} px; "
        f"classes and validity equal {same}; "
        f"{int(got['gt_valid'].sum())} boxes kept, "
        f"{int(on_card.do_mixup.sum())} images mixed")
    if off > (1 - AUG_PIXEL_SHARE) * px.numel() or box_err > AUG_BOX_TOL \
            or not same:
        raise AssertionError("(25a) DeviceAug on the card differs from the "
                             "CPU")
    aug_ms = cuda_ms(lambda: aug.apply(tiles, on_card))
    photo = DevicePhotometric(cfg)
    packed = {k: v.to(dev) for k, v in train_batch(n, gen).items()}
    pdraws = photo.draw(torch.Generator().manual_seed(SEED), n,
                        SIZE, SIZE).to(dev)
    photo_ms = cuda_ms(lambda: photo.apply(packed, pdraws))
    log(f"(25a) DeviceAug on [{card}]: {aug_ms:.3f} ms a batch of {n} "
        f"(CUDA events, {ITERS} calls after {WARMUP}) = "
        f"{n * 1e3 / aug_ms:.1f} img/s; the packed photometric stage "
        f"(MixUp, HSV, GridMask, flip) {photo_ms:.3f} ms on the same card")
    del host, tiles, ref, got, packed, px
    torch.cuda.empty_cache()

    # ---- (b) the step: make_device_aug_step, the passthrough from step 2
    bcfg = dataclasses.replace(cfg, aug_disable_at_iter=2)
    _, state, step = build_yolox_system(bcfg, device=dev, seed=SEED)
    step = make_device_aug_step(bcfg, step, seed=SEED)
    batches = [device_tiles(n, gen) for _ in range(3)]
    before = snapshot(state)
    metrics, per_step = [], []
    torch.cuda.synchronize()
    build.reset_launches()
    for b in batches:
        state, m = step(state, b)
        torch.cuda.synchronize()
        metrics.append(m)
        per_step.append(dict(build.LAUNCHES))
    launches = dict(build.LAUNCHES)
    log(f"(25b) make_device_aug_step launches after each step: {per_step}")
    if launches.get("grid_mask", 0) != 2 or launches.get("normalize", 0) != 1 \
            or per_step[1].get("normalize", 0):
        raise AssertionError(f"(25b) launches {per_step}: GridMask at steps "
                             "0-1, the normalize kernel at step 2 only")
    for i, m in enumerate(metrics):
        for key in ("total_loss", "loss_iou", "loss_obj", "loss_cls",
                    "grad_norm"):
            if not math.isfinite(float(m[key])):
                raise AssertionError(f"(25b) step {i}: {key} = "
                                     f"{float(m[key])}")
        if not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"(25b) step {i}: no foreground anchor")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"(25b) training moved no {key} tensor")
    kernels["grid_mask"]["launches"] += launches["grid_mask"]
    kernels["normalize"]["launches"] += launches["normalize"]
    log(f"(25b) YOLOX-s 640 bf16, {n} tiles a step through "
        f"make_device_aug_step: total loss " + ", ".join(
            f"{float(m['total_loss']):.4f}" for m in metrics)
        + f"; GridMask-ed {[m['grid_masked'] for m in metrics]}; step 2 "
        f"the uint8 passthrough; parameters, EMA and BN statistics moved")
    del state, step, batches, before, after, metrics
    torch.cuda.empty_cache()

    # ---- (c) remat against the step without, float32
    ycfg = dataclasses.replace(YoloxConfig(), amp=False)
    ybatch = {k: v.to(dev) for k, v in train_batch(n, gen).items()}
    dcfg = detr_cfg(DETR_MODELS[0][1], amp=False)
    dbatch = detr_batch(DETR_TRAIN_BATCH, gen, dev)

    def yolox(remat):
        def build_fn():
            _, st, sp = build_yolox_system(
                dataclasses.replace(ycfg, remat=remat), device=dev,
                seed=SEED)
            return st, sp
        return build_fn

    def detr(**replace):
        def build_fn():
            _, st, sp, _ = build_system(dataclasses.replace(dcfg, **replace),
                                        device=dev, seed=SEED)
            return st, sp
        return build_fn

    cases = [("YOLOX-s 640 f32", n, False, ybatch,
              (("without", yolox(False)), ("TPU.REMAT", yolox(True)))),
             (f"DETR R-50 800 f32 dropout {dcfg.dropout}", DETR_TRAIN_BATCH,
              True, dbatch,
              (("without", detr()), ("MODEL.DETR.REMAT",
                                     detr(layer_remat=True)),
               ("TPU.REMAT", detr(remat=True))))]
    for what, bs, sdpa, batch, runs in cases:
        with deterministic_library(sdpa):
            records = [(name, remat_record(fn, batch)) for name, fn in runs]
        want = records[0][1]
        for name, rec in records:
            gaps = ("" if rec is want else
                    "; against the step without: "
                    + remat_gaps(rec, want, f"{what} {name}"))
            log(f"(25c) {what} step of {bs}, {name} remat on [{card}]: "
                f"total loss {rec['metrics']['total_loss']:.6g}, peak "
                f"memory {rec['peak_gb']:.3f} GB, {rec['ms']:.3f} ms a step "
                f"(host clock, {REMAT_STEPS - 1} steps after 1){gaps}")
        del records, want
        torch.cuda.empty_cache()
    log(f"(25) section 25 in {time.perf_counter() - t0:.1f} s on [{card}]")


def snapshot(state) -> dict:
    model = state.model
    return {
        "params": [p.detach().clone() for p in model.parameters()],
        "ema": [e.clone() for e in state.ema_params.values()],
        "bn": [b.clone() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this check runs only "
                           "on a card")
    sys.path.insert(0, REPO)
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.data.device_aug import (
        DevicePhotometric,
        PhotoDraws,
        make_packed_photo_step,
    )
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.kernels import build
    from yolov7_d2_tpu_torch.kernels.grid_mask import (
        grid_mask,
        grid_mask_plain,
    )
    from yolov7_d2_tpu_torch.kernels.nms import nms_batched, nms_batched_plain
    from yolov7_d2_tpu_torch.kernels.preprocess import (
        normalize_images,
        normalize_images_plain,
    )
    from yolov7_d2_tpu_torch.ops.nms import _class_offset_boxes
    from yolov7_d2_tpu_torch.predictor import Predictor

    # ---- 1. device
    t_run = time.perf_counter()

    def mark(section: str) -> None:
        log(f"({section}) done {time.perf_counter() - t_run:.1f} s into "
            "the run")

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator().manual_seed(SEED)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load_library()
    nvcc = ("found built" if build.BUILD_SECONDS is None
            else f"nvcc {build.BUILD_SECONDS:.2f} s")
    log(f"build: kernels ready in {time.perf_counter() - t0:.2f} s ({nvcc})")

    kernels = {}

    # ---- 3. normalize kernel vs its plain version, [128, 640, 640, 3]
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    cases = [((0.0,) * 3, (1.0,) * 3, torch.bfloat16),
             (PIXEL_MEAN, PIXEL_STD, torch.float32)]
    norm_err = 0.0
    for mean, std, dtype in cases:
        got = normalize_images(images, mean, std, dtype)
        want = normalize_images_plain(images, mean, std, dtype)
        torch.cuda.synchronize()
        if got.stride() != want.stride() or not torch.equal(got, want):
            raise AssertionError(
                f"normalize kernel differs from its plain version: mean "
                f"{mean} {dtype}")
        norm_err = max(norm_err,
                       float((got.float() - want.float()).abs().max()))
        del got, want
    log(f"normalize: bit-exact against its plain version on "
        f"{tuple(images.shape)} -> channels_last (bf16 identity and f32 "
        f"pixel mean/std)")
    main_args = (images, (0.0,) * 3, (1.0,) * 3, torch.bfloat16)
    kernels["normalize"] = {
        "name": "normalize", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/preprocess.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:34",
        "max_abs_err": norm_err,
        "plain_ms": kernel_ms(lambda: normalize_images_plain(*main_args),
                              host_ok="normalize plain"),
        "ms": kernel_ms(lambda: normalize_images(*main_args)),
        # the identity case as one PyTorch call: cast into channels_last
        "library_ms": kernel_ms(lambda: images.permute(0, 3, 1, 2).to(
            torch.bfloat16, memory_format=torch.channels_last),
            host_ok="normalize library"),
        # u8 read once, bf16 written once; a subtract and a divide each
        **bound(images.numel() * 3, images.numel() * 2),
    }
    del images

    mark("3")

    # ---- 4. NMS kernel vs its plain version, [128, 1024], 80 classes
    boxes, scores, cls = random_nms_inputs(dev, gen)
    shifted = _class_offset_boxes(boxes, cls).contiguous()
    got = nms_batched(shifted, scores, 0.65, 100)
    want = nms_batched_plain(shifted, scores, 0.65, 100)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"NMS kernel differs from its plain version "
                             f"in {bad} slots")
    nms_err = float((got[0] - want[0]).abs().max())
    # the work this run's data needs: the IoU tests of the greedy walk
    # (about 15 float32 operations each); boxes and scores read once, the
    # kept indices and flags written once
    nms_ops = float(nms_walk_pairs(scores, *got, 100)) * 15
    nms_bytes = (boxes.numel() + scores.numel()) * 4 + got[1].numel() * 5
    log(f"nms: index-exact against its plain version on "
        f"{tuple(scores.shape)}, thr 0.65, max_out 100, 80 classes; kept "
        f"{int(got[1].sum())} of {got[1].numel()} slots")
    kernels["nms"] = {
        "name": "nms", "route": "cuda",
        "source": "yolov7_d2_tpu_torch/csrc/nms.cu",
        "replaces": "yolov7_d2_tpu/ops/pallas_nms.py:34",
        "max_abs_err": nms_err,
        "plain_ms": kernel_ms(lambda: nms_batched_plain(shifted, scores,
                                                      0.65, 100),
                              host_ok="nms plain"),
        "ms": kernel_ms(lambda: nms_batched(shifted, scores, 0.65, 100)),
        "library_ms": None,  # no torchvision: no PyTorch call does NMS
        **bound(nms_bytes, nms_ops),
    }
    one_box, one_score = shifted[:1].contiguous(), scores[:1].contiguous()
    one_ms = kernel_ms(lambda: nms_batched(one_box, one_score, 0.65, 100))
    one_plain_ms = kernel_ms(
        lambda: nms_batched_plain(one_box, one_score, 0.65, 100),
        host_ok="nms plain bs 1")
    log(f"nms bs 1 {tuple(one_score.shape)} on [{card}]: kernel "
        f"{one_ms:.4f} ms, plain PyTorch {one_plain_ms:.4f} ms")
    crowd, crowd_scores = crowd_nms_inputs(dev, gen)
    got = nms_batched(crowd, crowd_scores, 0.3, 100)
    want = nms_batched_plain(crowd, crowd_scores, 0.3, 100)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"NMS kernel differs from its plain version "
                             f"in {bad} slots, one class")
    kept = got[1].sum(1)
    if not 0 < int(kept.max()) < 100:
        raise AssertionError("the one-class case did not scan every tile")
    crowd_ms = kernel_ms(lambda: nms_batched(crowd, crowd_scores, 0.3, 100))
    log(f"nms one class, thr 0.3: index-exact on {tuple(crowd_scores.shape)};"
        f" kept {int(kept.min())}-{int(kept.max())} an image; kernel "
        f"{crowd_ms:.4f} ms on [{card}]")
    del boxes, scores, cls, shifted, got, want, one_box, one_score
    del crowd, crowd_scores

    mark("4")

    # ---- 5. GridMask kernel vs its plain version, [16, 640, 640, 3], the
    # float32 images of the training path and the uint8 ones it gets with
    # mixup off; drawn parameters in both modes and identity rows
    gparams, u8, f32 = grid_mask_inputs(dev, gen)
    for name, imgs in (("grid_mask_u8", u8), ("grid_mask", f32)):
        got = grid_mask(imgs, gparams)
        want = grid_mask_plain(imgs, gparams)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"GridMask kernel differs from its plain "
                                 f"version on {imgs.dtype}")
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": "yolov7_d2_tpu_torch/csrc/grid_mask.cu",
            "replaces": "yolov7_d2_tpu/ops/pallas_preprocess.py:83",
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": kernel_ms(lambda: grid_mask(imgs, gparams)),
            "plain_ms": kernel_ms(lambda: grid_mask_plain(imgs, gparams),
                                  host_ok=f"{name} plain"),
            "library_ms": None,  # no single PyTorch call computes GridMask
            # read once, written once; one select an element
            **bound(imgs.numel() * imgs.element_size() * 2, imgs.numel()),
        }
    zeroed = [round(float(z), 3)
              for z in (got == 0).all(-1).flatten(1).float().mean(1)]
    log(f"grid_mask: bit-exact against its plain version on "
        f"{tuple(u8.shape)} uint8 and float32; share zeroed an image "
        f"{zeroed}")
    del imgs, u8, f32, got, want

    mark("5")

    # ---- 6. serving: YOLOX-s 640, bf16, requests of 1, 8, 128 images
    cfg = YoloxConfig()
    predictor = Predictor(cfg, device=dev, seed=SEED)
    requests = [letterboxed_batch(n, gen) for n in REQUEST_BATCHES]
    torch.cuda.synchronize()
    build.reset_launches()
    results = [predictor.predict_batch(r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"main path launches: {launches}")
    for name in ("normalize", "nms"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the main path never launched {name}")
        kernels[name]["launches"] = launches[name]
    for req, dets in zip(requests, results):
        n = req.shape[0]
        if dets.boxes.shape != (n, cfg.max_detections, 4) or \
                dets.scores.shape != (n, cfg.max_detections) or \
                dets.valid.shape != (n, cfg.max_detections):
            raise AssertionError(f"bs {n}: Detections shapes "
                                 f"{tuple(dets.boxes.shape)}")
        counts = dets.num_valid()
        if int(counts.min()) < 1:
            raise AssertionError(f"bs {n}: an image with no detection")
        if not torch.isfinite(dets.boxes[dets.valid]).all():
            raise AssertionError(f"bs {n}: non-finite boxes")
        log(f"request bs {n}: detections per image min {int(counts.min())} "
            f"max {int(counts.max())}")

    # kernel path vs plain NMS path on the same bs-128 head outputs
    big = requests[-1].to(dev)
    head = predictor.forward(big)
    with_kernel = predictor.postprocess(head)
    with_plain = predictor.postprocess(head, nms=nms_batched_plain)
    for field in ("valid", "classes", "boxes", "scores"):
        if not torch.equal(getattr(with_kernel, field),
                           getattr(with_plain, field)):
            raise AssertionError(f"bs {BATCH}: Detections.{field} of the "
                                 "kernel path differ from the plain path")
    log(f"bs {BATCH}: kernel-path Detections equal the plain-path ones")

    # the card against the CPU on a small input, float32 without TF32. The
    # f32 card forward runs the same modules, layout and normalize kernel
    # as the bf16 one, so it is the check of BN, layout and weights: only
    # the convolutions' sum order differs from the CPU (measured on an H100:
    # 1.2e-5 of a max of 3.92, 3e-6 of it), and 1e-4 of the max leaves 30x
    # room. bf16 rounds every activation to 8 bits of mantissa (2**-8 =
    # 0.4% a rounding, through the model's depth); measured 2.2% of the
    # max, so 5e-2 bounds only gross faults of the autocast path.
    f32 = dataclasses.replace(cfg, amp=False)
    small = requests[0]
    ref = Predictor(f32, device="cpu", seed=SEED).forward(small)
    on_card = Predictor(f32, device=dev, seed=SEED).forward(small)
    bf16 = predictor.forward(small)
    ref_out = ref["outputs"]
    scale = float(ref_out.abs().max())
    err32 = float((on_card["outputs"].cpu() - ref_out).abs().max())
    err16 = float((bf16["outputs"].float().cpu() - ref_out).abs().max())
    log(f"bs 1 head outputs vs float32 on the CPU (max |ref| {scale:.4g}): "
        f"float32 card max err {err32:.4g}, bf16 card max err {err16:.4g}")
    if err32 > 1e-4 * scale or err16 > 5e-2 * scale:
        raise AssertionError("head outputs disagree with the CPU reference")
    if not torch.equal(on_card["grids"].cpu(), ref["grids"]) or \
            not torch.equal(on_card["strides"].cpu(), ref["strides"]):
        raise AssertionError("grids or strides differ from the CPU")

    mark("6")

    # ---- 7. serving times: each request size, the batch already on the card
    for req in requests:
        n = req.shape[0]
        x = req.to(dev)
        e2e_ms = cuda_ms(lambda: predictor.predict_batch(x))
        fwd_ms = cuda_ms(lambda: predictor.forward(x))
        head = predictor.forward(x)
        tail_ms = cuda_ms(lambda: predictor.postprocess(head))
        log(f"YOLOX-s 640 bs {n} bf16 on [{card}]: e2e {e2e_ms:.3f} ms = "
            f"{n * 1000 / e2e_ms:.1f} img/s; forward-only {fwd_ms:.3f} ms = "
            f"{n * 1000 / fwd_ms:.1f} img/s; tail {tail_ms:.3f} ms")
    del predictor, requests, results, big, head, with_kernel, with_plain, x
    del ref, on_card, bf16
    torch.cuda.empty_cache()

    mark("7")

    # ---- 8. training: YOLOX-s 640, bf16, 16 images a step, GridMask on
    tcfg = dataclasses.replace(cfg, grid_mask=True)
    _, state, train_step = build_yolox_system(tcfg, device=dev, seed=SEED)
    step = make_packed_photo_step(tcfg, train_step, seed=SEED)
    batches = [{k: v.to(dev) for k, v in train_batch(TRAIN_BATCH,
                                                     gen).items()}
               for _ in range(4)]
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for i in range(WARMUP):
        state, m = step(state, batches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + ITERS):
        state, m = step(state, batches[i % 4])
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"training path launches: {launches}")
    if launches.get("grid_mask", 0) < 1:
        raise AssertionError("the training path never launched grid_mask")
    kernels["grid_mask"]["launches"] = launches["grid_mask"]
    masked = sum(m["grid_masked"] for m in metrics)
    if masked < 1:
        raise AssertionError("GridMask masked no image in the training run")
    for i, m in enumerate(metrics):
        for key in ("loss_iou", "loss_obj", "loss_cls", "loss_l1",
                    "total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"step {i}: {key} = {float(m[key])}")
        if not float(m["num_fg"]) > 1.0:
            raise AssertionError(f"step {i}: no foreground anchor")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"training moved no {key} tensor")
    fmt = ("total_loss", "loss_iou", "loss_obj", "loss_cls", "num_fg",
           "grad_norm")
    for i in (0, len(metrics) - 1):
        log(f"train step {i}: " + ", ".join(
            f"{k} {float(metrics[i][k]):.4f}" for k in fmt))
    log(f"training: {masked} of {TRAIN_BATCH * len(metrics)} images "
        f"GridMask-ed; parameters, EMA and BN statistics moved")
    del state, train_step, step, before, after, metrics
    torch.cuda.empty_cache()

    mark("8")

    # ---- 8b. training with mixup off: the images stay uint8 through the
    # GridMask kernel and into the normalize kernel at the model's head
    ucfg = dataclasses.replace(tcfg, mixup=False)
    _, state, train_step = build_yolox_system(ucfg, device=dev, seed=SEED)
    step = make_packed_photo_step(ucfg, train_step, seed=SEED + 1)
    before = snapshot(state)
    metrics = []
    torch.cuda.synchronize()
    build.reset_launches()
    for i in range(3):
        state, m = step(state, batches[i])
        metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"training path, mixup off, launches: {launches}")
    for name in ("grid_mask", "normalize"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the mixup-off training path never "
                                 f"launched {name}")
    kernels["grid_mask_u8"]["launches"] = launches["grid_mask"]
    masked = sum(m["grid_masked"] for m in metrics)
    if masked < 1:
        raise AssertionError("GridMask masked no image with mixup off")
    for i, m in enumerate(metrics):
        for key in ("total_loss", "grad_norm"):
            if not bool(torch.isfinite(m[key])):
                raise AssertionError(f"mixup off, step {i}: {key} = "
                                     f"{float(m[key])}")
    after = snapshot(state)
    for key in before:
        if all(torch.equal(a, b) for a, b in zip(before[key], after[key])):
            raise AssertionError(f"training with mixup off moved no {key} "
                                 "tensor")
    log(f"training, mixup off: {masked} of {TRAIN_BATCH * 3} uint8 images "
        f"GridMask-ed; total loss {float(metrics[0]['total_loss']):.4f} -> "
        f"{float(metrics[-1]['total_loss']):.4f}; parameters, EMA and BN "
        f"statistics moved")
    del state, train_step, step, batches, before, after, metrics
    torch.cuda.empty_cache()

    mark("8b")

    # ---- 9. one float32 train step, the card against the CPU: TF32 off,
    # width 0.25, 128 px, 2 images, the same weights, batch and draws
    # (GridMask parameters fixed). The forward differs from the CPU in the
    # convolutions' sum order only (1.2e-5 of its max in eval mode, section
    # 6), which train-mode BatchNorm and the losses carry to about 1e-5
    # relative; 1e-3 leaves room, and the fg count is exact unless an
    # assignment sits at a tie.
    scfg = dataclasses.replace(cfg, width_mul=0.25, input_size=(128, 128),
                               amp=False, grid_mask=True, warmup_iters=0)
    sbatch = train_batch(2, gen, 128)
    draws = PhotoDraws(
        perm=torch.tensor([1, 0]), do_mix=torch.tensor([True, False]),
        grid_params=torch.tensor([[16, 8, 3, 5, 1], [12, 6, 2, 7, 0]],
                                 dtype=torch.int32),
        do_flip=torch.tensor([False, True]))
    small_metrics = {}
    for where in ("cpu", dev):
        _, st, ts = build_yolox_system(scfg, device=where, seed=SEED)
        b = DevicePhotometric(scfg).apply(
            {k: v.to(where) for k, v in sbatch.items()}, draws)
        _, m = ts(st, b)
        small_metrics[str(where)] = {k: float(v) for k, v in m.items()}
    ref_m, card_m = small_metrics["cpu"], small_metrics[str(dev)]
    log("float32 train step, card vs CPU: " + ", ".join(
        f"{k} {card_m[k]:.6g} / {ref_m[k]:.6g}" for k in fmt))
    if card_m["num_fg"] != ref_m["num_fg"]:
        raise AssertionError("fg count differs between the card and the CPU")
    for k in ("total_loss", "loss_iou", "loss_obj", "loss_cls", "grad_norm"):
        if abs(card_m[k] - ref_m[k]) > 1e-3 * abs(ref_m[k]):
            raise AssertionError(f"{k} differs between the card and the CPU")

    data = write_cli_data()
    median_a, median_b, median_c, launches_c = cli_phase(dev, card, kernels,
                                                         data)

    mark("9 and the CLI")

    # ---- 10. multi-GPU training: (a) two gloo ranks on one card against
    # one process, (b) the CLI in an NCCL group of 1, (c) NCCL ranks
    # one spawn of 2 gloo ranks runs the ranks' part of (a), of its
    # SyncBatchNorm2d check and of 17 (a) (SparseInst, DETR) in turn: each
    # rank starts once
    plans = {"sync": sync_plan(dev, cfg), "bn": sync_bn_plan(dev),
             **{family: family_plan(dev, family)
                for family, _ in FAMILY_RANKS}}
    spawn_plans(list(plans.values()), 2, "gloo")
    sync_phase(dev, card, cfg, plan=plans["sync"])
    sync_bn_phase(dev, card, plan=plans["bn"])
    ddp_world1_phase(dev, card, kernels, data, cfg)
    for name in ("grid_mask", "normalize", "nms"):
        kernels[name]["launches"] += launches_c[name]   # the CLI's run C
    nccl_ranks_phase(dev, card, cfg, data)
    DatasetCatalog.remove(CLI_DATASET)
    shutil.rmtree(data.work, ignore_errors=True)

    mark("10")

    # ---- 11. the anchor-YOLO family: YOLOV7 serving and training, then
    # YOLO and YOLOV7P, YOLOV7P on ResNet-50 (anchor_yolo_phase)
    anchor_yolo_phase(dev, card, gen)

    mark("11")

    # ---- 12. SparseInst R-50: the normalize kernel at its statistics,
    # serving, card against CPU, training, train_inseg (sparseinst_phase)
    sparseinst_phase(dev, card, gen, kernels)

    mark("12")

    # ---- 13. DETR and AnchorDETR R-50 at 800: the normalize kernel at
    # their statistics, serving, card against CPU, training,
    # train_transformer (detr_phase)
    detr_phase(dev, card, gen, kernels)

    mark("13")

    # ---- 14. YOLOX-KPTS on Swin-T, CSPDarknet-X and PVTv2-b1: serving,
    # card against CPU, training, eval_coco; YOLOV7 on Swin-T and PVTv2-b0
    # (yolox_kpts_phase)
    yolox_kpts_phase(dev, card, gen, kernels)

    mark("14")

    # ---- 15. the one-stage box detectors: YOLOv5-s, YOLOv6-s and YOLOF
    # R-50 serving, card against CPU, training; YOLOv6-tiny, YOLOv6-m and
    # YOLOV7 R-50 with the bifpn and pan necks (onestage_phase)
    onestage_phase(dev, card, gen, kernels)

    mark("15")

    # ---- 16. C.14: is the training step bitwise repeatable, and which
    # kernel parts two runs (c14_phase)
    c14_phase(dev, card)

    mark("16")

    # ---- 17. multi-GPU SparseInst and DETR: (a) two gloo ranks on one
    # card against one process, (b) the CLIs in an NCCL group of 1, (c)
    # NCCL ranks where two or more cards are visible
    for family, _ in FAMILY_RANKS:
        family_sync_phase(dev, card, family, plan=plans[family])
        family_cli_phase(dev, card, family, kernels, images=CLI_IMAGES // 2)
        family_nccl_phase(dev, card, family)

    mark("17")

    # ---- 18. YOLOV7 on Res2Net-50 (configs/coco/r2_50.yaml): serving,
    # card against CPU, training; r2next_50, r2_50_l and tl/res2net_bifpn
    # one request and one step each (anchor_yolo_phase)
    anchor_yolo_phase(dev, card, gen, yaml="r2_50.yaml", label="18",
                      others=RES2NET_OTHERS, f32_px=128, kernels=kernels,
                      f64_step=True)

    mark("18")

    # ---- 19. the backbone zoo and the other DETR variants: YOLOX on
    # ConvNeXt-T and SMCA-DETR R-50 at 800 (serving, card against CPU,
    # training, the CLIs), every other yaml they unlock one request and one
    # step (zoo_phase)
    zoo_phase(dev, card, gen, kernels)

    mark("19")

    # ---- 20. deformable convolution and the last mask families:
    # SparseInst R-50-DCN at 608 and SOLOv2 R-50 at 640 (serving, card
    # against CPU, training; train_inseg on the DCN config), every other
    # yaml they unlock one request and one step (mask_phase)
    mask_phase(dev, card, gen, kernels)

    mark("20")

    # ---- 21. LazyConfig and the R-CNN family: Mask R-CNN R-50-FPN at 1024
    # and Panoptic FPN at 640 from their LazyConfig files (serving, card
    # against CPU, training), the other 16 files and Faster R-CNN one
    # request and one step each, the two LazyConfig entry points, and the
    # repeatability of the DCN and Mask R-CNN float32 steps (rcnn_phase)
    rcnn_phase(dev, card, gen, kernels)

    mark("21")

    # ---- 22. the library remainder and the closure: the library NMS suite
    # on K1 at [1, 1000] (the nms_single entry), one train step of every
    # yaml of configs/ at 64-128 px (closure_phase)
    closure_phase(dev, card, gen, kernels)

    mark("22")

    # ---- 23. deploy and the rest of the feed: YOLOX-s exported (the CLI,
    # a fresh process, bs 1 / 8 / 128, bf16 and float32) against
    # Predictor, int8 and pruning served, the C.45 pairings, the
    # process-worker loader, HSV on the card, multi-scale steps
    # (deploy_feed_phase)
    deploy_feed_phase(dev, card, gen, kernels)

    mark("23")

    # ---- 24. tensor parallelism: YOLOX-s 640 on a (2, 2) grid of 4 gloo
    # ranks on the card, the widest parameters sharded over the model
    # axis: (a) the float32 step against one process, (b) bf16 steps with
    # MixUp and GridMask, (c) the grid over NCCL where 2 or more cards are
    # visible (tensor_parallel_phase)
    tensor_parallel_phase(dev, card, cfg, kernels)
    grid_nccl_phase(card, cfg)

    mark("24")

    # ---- 25. the device geometry feed and rematerialization: DeviceAug
    # at [16, 640, 640, 3] against the CPU, 3 steps through
    # make_device_aug_step, remat against the step without for YOLOX-s and
    # DETR (device_aug_remat_phase); run C of the CLI is in section 9
    device_aug_remat_phase(dev, card, gen, kernels)

    mark("25")

    # ---- 26. times
    log(f"YOLOX-s 640 train step bs {TRAIN_BATCH} bf16 on [{card}]: "
        f"{step_ms:.3f} ms a step = {TRAIN_BATCH * 1000 / step_ms:.1f} img/s "
        f"(host clock over {ITERS} steps after {WARMUP}, batches on the "
        f"card); peak memory {peak_gb:.3f} GB; a CLI step takes "
        f"{median_a * 1e3 / step_ms:.3f}x that on the host mosaic feed, "
        f"{median_b * 1e3 / step_ms:.3f}x on the packed feed, "
        f"{median_c * 1e3 / step_ms:.3f}x on the device geometry feed")
    for k in kernels.values():
        log(f"{k['name']} on [{card}]: kernel {k['ms']:.4f} ms, plain "
            f"PyTorch {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), library "
            + ("none" if k["library_ms"] is None
               else f"{k['library_ms']:.4f} ms"))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    mark("26, the whole script")
    print(card, flush=True)
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def nccl_main() -> int:
    """``python3 chip_smoke.py --nccl``: sections 10 (c), 17 (c) and 24 (c)
    alone, on every visible card up to 4 (the paths that exist only across
    cards, for a machine of several); the kernels are built first, so that
    the ranks only load them."""
    if torch.cuda.device_count() < 2:
        raise RuntimeError("chip_smoke --nccl: needs 2 or more CUDA cards")
    sys.path.insert(0, REPO)
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.kernels import build

    card = card_line()
    log(f"card: {card} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    data = write_cli_data()
    nccl_ranks_phase(torch.device("cuda", 0), card, YoloxConfig(), data)
    DatasetCatalog.remove(CLI_DATASET)
    shutil.rmtree(data.work, ignore_errors=True)
    for family, _ in FAMILY_RANKS:
        family_nccl_phase(torch.device("cuda", 0), card, family)
    grid_nccl_phase(card, YoloxConfig())
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run-program"]:
        sys.exit(run_program_main(sys.argv[2:]))
    sys.exit(nccl_main() if sys.argv[1:] == ["--nccl"] else main())
