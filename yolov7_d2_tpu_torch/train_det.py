"""Detection training CLI of the port (the JAX package's ``train_det.py``).

    python -m yolov7_d2_tpu_torch.train_det --config-file configs/coco/yolox_s.yaml \
        [--resume] [--eval-only] [KEY VALUE ...]

Config -> COCO records (``DATASETS.TRAIN`` / ``TEST`` from the catalog) ->
a feed -> ``build_yolox_system`` -> the trainer with its hooks (timer,
aug-disable, periodic checkpoint, periodic COCO eval, writers) ->
``OUTPUT_DIR/metrics.json`` and ``OUTPUT_DIR/ckpt``. It runs on
``MODEL.DEVICE`` (``cuda`` by default; ``MODEL.DEVICE cpu`` runs on the
CPU) on one device: ``--num-gpus`` or ``--num-machines`` above 1 raise.

Feeds:

* host mosaic (``configs/coco/yolox_s.yaml`` as it stands):
  ``YOLOXDatasetMapper`` in the threaded ``DataLoader``, float32 images,
  ``AugDisableHook`` at ``DISABLE_AT_ITER``;
* packed shards (``DATALOADER.PACKED_CACHE_DIR``, optional
  ``PACKED_CACHE_PLAIN_DIR`` from ``DISABLE_AT_ITER`` on): uint8 images
  through ``make_packed_photo_step`` (mixup, the GridMask kernel, flip on
  the card).

Either way the batches reach the card through ``CudaPrefetcher``. The COCO
eval runs ``Predictor.predict_batch`` (the normalize and NMS kernels) on
the EMA weights.
"""

from __future__ import annotations

import copy
import logging
import os
import types

import numpy as np
import torch

logger = logging.getLogger("yolov7_d2_tpu_torch")

TRAIN_FIELDS = ("image", "gt_boxes", "gt_classes", "gt_valid")


def exact_uint8(images: np.ndarray) -> np.ndarray:
    """The eval mapper's float32 images as uint8. The cast is exact only
    where every value is an integer in [0, 255], which the letterboxed
    uint8 decode gives; anything else raises (nothing is rounded)."""
    with np.errstate(invalid="ignore"):  # NaN or out of range: caught below
        out = images.astype(np.uint8)
    if not np.array_equal(out, images):
        raise ValueError("eval images are not integers in [0, 255]: the "
                         "uint8 input of the predictor would change them")
    return out


def eval_model(state) -> torch.nn.Module:
    """A copy of the training model in eval mode, with the EMA weights
    where the state has an EMA and the model's BatchNorm buffers; the
    training model is left as it is."""
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.requires_grad_(False)
            if state.ema_params is not None:
                p.copy_(state.ema_params[name])
    return model.eval()


def build_eval_fn(cfg, eval_records):
    """Periodic COCO evaluation over the TEST dataset: ``eval_fn(trainer)
    -> {metric: value}`` for the finite metrics of ``COCOEvaluator``."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.loader import build_detection_test_loader
    from yolov7_d2_tpu_torch.data.mappers import (
        SimpleDatasetMapper,
        annotations_to_arrays,
    )
    from yolov7_d2_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from yolov7_d2_tpu_torch.predictor import Predictor

    mapper = SimpleDatasetMapper(cfg, is_train=False)
    ycfg = YoloxConfig.from_cfg(cfg)
    # GT straight from the original annotations — round-tripping GT through
    # the letterboxed coordinates clips boxes at letterbox edges and skews AP
    gt_by_id = {
        int(r.get("image_id", i)): annotations_to_arrays(r)
        for i, r in enumerate(eval_records)
    }

    def eval_fn(trainer):
        evaluator = COCOEvaluator(cfg.MODEL.YOLO.CLASSES)
        loader = build_detection_test_loader(cfg, eval_records, mapper)
        model = eval_model(trainer.state)
        predictor = Predictor(ycfg, next(model.parameters()).device,
                              model=model)
        for batch in loader:
            dets = predictor.predict_batch(
                torch.from_numpy(exact_uint8(batch["image"])))
            boxes, scores, classes, valid = (
                t.cpu().numpy() for t in (dets.boxes, dets.scores,
                                          dets.classes, dets.valid))
            for i in range(len(batch["image"])):
                img_id = int(batch["image_id"][i])
                scale = float(batch["scale"][i])
                evaluator.add_predictions(
                    img_id, boxes[i][valid[i]] / scale,
                    scores[i][valid[i]], classes[i][valid[i]])
                gt_boxes, gt_classes = gt_by_id[img_id]
                evaluator.add_gt(img_id, gt_boxes, gt_classes)
        results = evaluator.evaluate()
        logger.info(f"COCO eval: {results}")
        return {k: v for k, v in results.items() if np.isfinite(v)}

    return eval_fn


def main(args):
    """Train as the config says and return the ``Trainer`` (its
    ``storage`` holds the last scalars, the eval results as
    ``eval/<metric>``); with ``--eval-only``, evaluate and return the eval
    dict."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.data.loader import (
        CudaPrefetcher,
        build_detection_train_loader,
    )
    from yolov7_d2_tpu_torch.engine import build_yolox_system, resolve_device
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
    from yolov7_d2_tpu_torch.train.schedules import auto_scale_config
    from yolov7_d2_tpu_torch.train.trainer import (
        AugDisableHook,
        EvalHook,
        IterationTimer,
        PeriodicCheckpointer,
        PeriodicWriter,
        Trainer,
    )
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    if args.num_gpus > 1 or args.num_machines > 1:
        raise NotImplementedError(
            "training on more than one GPU is not ported yet (ROADMAP.md "
            "Queue A.6); run with --num-gpus 1 --num-machines 1")
    cfg = setup_cfg(args)
    cfg.defrost()
    auto_scale_config(cfg, 1)
    cfg.freeze()
    device = resolve_device(cfg.MODEL.DEVICE)
    packed_dir = str(cfg.DATALOADER.PACKED_CACHE_DIR)
    if cfg.INPUT.MOSAIC_AND_MIXUP.DEVICE and not packed_dir:
        raise NotImplementedError(
            "INPUT.MOSAIC_AND_MIXUP.DEVICE (the fused device geometry path, "
            "DeviceAug) is not ported (ROADMAP.md, 'Do not port'): use the "
            "host mosaic feed or DATALOADER.PACKED_CACHE_DIR")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())

    records = []
    for name in cfg.DATASETS.TRAIN:
        records.extend(DatasetCatalog.get(name))
    eval_records = []
    for name in cfg.DATASETS.TEST:
        eval_records.extend(DatasetCatalog.get(name))

    ycfg = YoloxConfig.from_cfg(cfg)
    seed = max(int(cfg.SEED), 0)  # SEED=-1 means "unseeded" (d2 convention)
    _, state, train_step = build_yolox_system(ycfg, device=device, seed=seed)
    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    state, start_iter = checkpointer.resume_or_load(state, resume=args.resume)
    if args.eval_only:
        results = build_eval_fn(cfg, eval_records)(
            types.SimpleNamespace(state=state))
        print(results)
        return results

    disable_at = int(cfg.INPUT.MOSAIC_AND_MIXUP.DISABLE_AT_ITER)
    if packed_dir:
        # offline geometry (packed shards, uint8) + the photometric stage on
        # the card (data/device_aug.py)
        from yolov7_d2_tpu_torch.data.device_aug import make_packed_photo_step
        from yolov7_d2_tpu_torch.data.packed_cache import (
            PackedShardLoader,
            SwitchingPackedLoader,
        )

        train_step = make_packed_photo_step(ycfg, train_step, seed=seed)
        loader = PackedShardLoader(
            packed_dir, cfg.SOLVER.IMS_PER_BATCH, image_dtype=np.uint8,
            seed=seed)
        plain_dir = str(cfg.DATALOADER.PACKED_CACHE_PLAIN_DIR)
        if plain_dir:
            # reference DISABLE_AT_ITER: plain resized images for the
            # final phase (dataset_mapper.py:400,490) — switch shard sets
            plain_loader = PackedShardLoader(
                plain_dir, cfg.SOLVER.IMS_PER_BATCH, image_dtype=np.uint8,
                seed=seed + 7919)
            loader = SwitchingPackedLoader(
                loader, plain_loader,
                switch_after=max(disable_at - start_iter, 0))
        elif disable_at < cfg.SOLVER.MAX_ITER:
            logger.warning(
                "PACKED_CACHE_DIR without PACKED_CACHE_PLAIN_DIR: after "
                "DISABLE_AT_ITER=%d only the device photometrics stop; "
                "the mosaic geometry baked into the shards keeps feeding "
                "(the reference switches to plain resized images). Write "
                "a plain shard set (data.packed_cache.write_plain_shards) "
                "and set DATALOADER.PACKED_CACHE_PLAIN_DIR for reference "
                "recipe fidelity.", disable_at)
        hooks = [IterationTimer()]
    else:
        from yolov7_d2_tpu_torch.data.mappers import YOLOXDatasetMapper

        mapper = YOLOXDatasetMapper(cfg, is_train=True, seed=0)
        loader = build_detection_train_loader(cfg, records, mapper)
        hooks = [IterationTimer(), AugDisableHook(mapper, disable_at)]

    hooks.append(PeriodicCheckpointer(checkpointer,
                                      cfg.SOLVER.CHECKPOINT_PERIOD))
    if cfg.TEST.EVAL_PERIOD > 0:
        hooks.append(EvalHook(cfg.TEST.EVAL_PERIOD,
                              build_eval_fn(cfg, eval_records)))
    # the writers last, so that the eval results of a step are written
    # with it (detectron2's hook order)
    hooks.append(PeriodicWriter(
        Trainer.default_writers(cfg.OUTPUT_DIR, cfg.SOLVER.MAX_ITER)))

    trainer = Trainer(
        train_step, state, CudaPrefetcher(loader, device, TRAIN_FIELDS),
        cfg.SOLVER.MAX_ITER, hooks=hooks, start_iter=start_iter)
    trainer.train()
    return trainer


if __name__ == "__main__":
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    logging.basicConfig(level=logging.INFO)
    main(default_argument_parser().parse_args())
