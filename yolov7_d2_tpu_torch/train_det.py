"""Detection training CLI of the port (the JAX package's ``train_det.py``).

    python -m yolov7_d2_tpu_torch.train_det --config-file configs/coco/yolox_s.yaml \
        [--resume] [--eval-only] [--num-gpus N] [--num-machines M \
        --machine-rank R --dist-url tcp://HOST:PORT] [KEY VALUE ...]

Config -> COCO records (``DATASETS.TRAIN`` / ``TEST`` from the catalog) ->
a feed -> ``build_yolox_system`` -> the trainer with its hooks (timer,
aug-disable, periodic checkpoint, periodic COCO eval, writers) ->
``OUTPUT_DIR/metrics.json`` and ``OUTPUT_DIR/ckpt``. It runs on
``MODEL.DEVICE`` (``cuda`` by default; ``MODEL.DEVICE cpu`` runs on the
CPU). ``--num-gpus N`` runs N processes a machine (``parallel.launch``),
one card each over NCCL (N processes on the CPU over gloo with
``MODEL.DEVICE cpu``). The processes form the grid of ``TPU.MESH_SHAPE``
over ``TPU.MESH_AXES`` (``parallel.mesh.build_grid``, as the JAX script
builds its mesh): each data rank takes ``IMS_PER_BATCH / data`` images a
step and seeds its loader and mapper with its data rank, and the step is
that of the global batch (synchronized BatchNorm, the global foreground
count, the summed gradient over the data axis). A model axis above 1
replicates the weights: the JAX CLIs never shard them, and neither does
this one. Rank 0 writes the metrics and checkpoints and runs the eval.
One process (the default) makes no process group.

Feeds:

* host mosaic (``configs/coco/yolox_s.yaml`` as it stands):
  ``YOLOXDatasetMapper`` in the threaded ``DataLoader``, float32 images,
  ``AugDisableHook`` at ``DISABLE_AT_ITER``;
* packed shards (``DATALOADER.PACKED_CACHE_DIR``, optional
  ``PACKED_CACHE_PLAIN_DIR`` from ``DISABLE_AT_ITER`` on): uint8 images
  through ``make_packed_photo_step`` (mixup, the GridMask kernel, flip on
  the card);
* the device geometry feed (``INPUT.MOSAIC_AND_MIXUP.DEVICE`` without
  packed shards, JAX ``train_det.py:172-180``): ``TileDatasetMapper``
  (decode and letterbox, uint8, ``orig_hw``) in the threaded
  ``DataLoader``, then ``make_device_aug_step`` (mosaic4, the perspective
  warp, MixUp, HSV, the GridMask kernel and the flip on the card, off from
  ``DISABLE_AT_ITER``).

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

from yolov7_d2_tpu_torch.data.loader import exact_uint8  # noqa: F401

logger = logging.getLogger("yolov7_d2_tpu_torch")

TRAIN_FIELDS = ("image", "gt_boxes", "gt_classes", "gt_valid")


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


def launch_main(main_fn, args):
    """``main_fn(args)`` on ``args.num_gpus`` processes of this machine
    (``parallel.launch``): over NCCL, or gloo where the config's
    ``MODEL.DEVICE`` is the CPU. A ``spawn``-ed rank starts with an empty
    dataset catalog, so each first registers the calling process's COCO
    datasets (``coco_registrations``). Returns the result in a world of
    1."""
    from yolov7_d2_tpu_torch.data.catalog import coco_registrations
    from yolov7_d2_tpu_torch.parallel.launch import launch
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    cpu = torch.device(setup_cfg(args).MODEL.DEVICE).type == "cpu"
    return launch(_registered_main, args.num_gpus, args.num_machines,
                  args.machine_rank, args.dist_url,
                  args=(main_fn, coco_registrations(), args),
                  backend="gloo" if cpu else "nccl")


def _registered_main(main_fn, datasets, args):
    """One rank of :func:`launch_main`: ``datasets`` (``(name, json,
    image_root)``) into this process's catalog where missing, then
    ``main_fn(args)``."""
    from yolov7_d2_tpu_torch.data.catalog import (
        DatasetCatalog,
        register_coco_instances,
    )

    for name, js, root in datasets:
        if name not in DatasetCatalog:
            register_coco_instances(name, {}, js, root)
    return main_fn(args)


def rank_share(cfg, world: int, rank: int):
    """``(grid, images)``: the grid of ``cfg.TPU.MESH_SHAPE`` over
    ``cfg.TPU.MESH_AXES`` in a world of ``world`` processes, seen from
    ``rank`` (``mesh.Grid.layout``, without groups), and the images of
    ``SOLVER.IMS_PER_BATCH`` that its data rank takes a step. The data rank
    seeds the rank's loader and mapper: the model ranks of a data slice
    read the same images."""
    from yolov7_d2_tpu_torch.parallel.mesh import Grid

    grid = Grid.layout(cfg.TPU.MESH_SHAPE, world, rank, cfg.TPU.MESH_AXES)
    if cfg.SOLVER.IMS_PER_BATCH % grid.data_size:
        raise ValueError(f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} does not "
                         f"divide into {grid.data_size} data ranks")
    return grid, cfg.SOLVER.IMS_PER_BATCH // grid.data_size


def rank_setup(args, scale=None):
    """A training CLI's start in one process of ``launch_main``: logging
    for a spawned rank (rank 0 logs progress), the config (``scale(cfg,
    world)`` applied where given: ``train_det``'s ``auto_scale_config``),
    the grid of ``TPU.MESH_SHAPE`` (``parallel.mesh.build_grid``), the
    device (a CUDA rank takes the card of its local rank) and, on rank 0,
    ``OUTPUT_DIR/config.yaml``. Returns ``(cfg, device)``."""
    from yolov7_d2_tpu_torch.engine import resolve_device
    from yolov7_d2_tpu_torch.parallel.dist import (
        get_local_rank,
        get_world_size,
        is_main_process,
    )
    from yolov7_d2_tpu_torch.parallel.mesh import build_grid
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    if get_world_size() > 1:
        # a spawned rank starts with no logging set up
        logging.basicConfig(level=logging.INFO if is_main_process()
                            else logging.WARNING)
    cfg = setup_cfg(args)
    if scale is not None:
        cfg.defrost()
        scale(cfg, get_world_size())
        cfg.freeze()
    build_grid(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES)
    device = resolve_device(cfg.MODEL.DEVICE)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", get_local_rank())
    if is_main_process():
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    return cfg, device


def main(args):
    """Train as the config says on ``args.num_gpus * args.num_machines``
    processes. In one process, return the ``Trainer`` (its ``storage``
    holds the last scalars, the eval results as ``eval/<metric>``), or
    with ``--eval-only`` the eval dict; None with more processes."""
    return launch_main(run, args)


def run(args):
    """The training of one process; returns its ``Trainer`` (with
    ``--eval-only``, the eval dict on rank 0 and None on the others)."""
    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.data.loader import (
        CudaPrefetcher,
        build_detection_train_loader,
    )
    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.parallel.dist import (
        get_rank,
        get_world_size,
        is_main_process,
        synchronize,
    )
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

    cfg, device = rank_setup(args, scale=auto_scale_config)
    grid, batch_size = rank_share(cfg, get_world_size(), get_rank())
    rank = grid.data_rank
    packed_dir = str(cfg.DATALOADER.PACKED_CACHE_DIR)
    device_aug = bool(cfg.INPUT.MOSAIC_AND_MIXUP.DEVICE) and not packed_dir

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
        results = None
        if is_main_process():
            results = build_eval_fn(cfg, eval_records)(
                types.SimpleNamespace(state=state))
            print(results)
        synchronize()
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

        # each data rank shuffles every record with its own seed, as the
        # JAX package's hosts do (seed + process_index)
        train_step = make_packed_photo_step(ycfg, train_step, seed=seed,
                                            rank=rank)
        loader = PackedShardLoader(
            packed_dir, batch_size, image_dtype=np.uint8, seed=seed + rank)
        plain_dir = str(cfg.DATALOADER.PACKED_CACHE_PLAIN_DIR)
        if plain_dir:
            # reference DISABLE_AT_ITER: plain resized images for the
            # final phase (dataset_mapper.py:400,490) — switch shard sets
            plain_loader = PackedShardLoader(
                plain_dir, batch_size, image_dtype=np.uint8,
                seed=seed + rank + 7919)
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
    elif device_aug:
        # the host decodes and letterboxes; mosaic, the warp, MixUp, HSV,
        # GridMask and the flip run on the card (data/device_aug.py), and
        # stop at DISABLE_AT_ITER inside the step: no AugDisableHook
        from yolov7_d2_tpu_torch.data.device_aug import make_device_aug_step
        from yolov7_d2_tpu_torch.data.mappers import TileDatasetMapper

        train_step = make_device_aug_step(ycfg, train_step, seed=seed,
                                          rank=rank)
        loader = build_detection_train_loader(
            cfg, records, TileDatasetMapper(cfg, is_train=True, seed=rank),
            seed=rank, batch_size=batch_size)
        hooks = [IterationTimer()]
    else:
        from yolov7_d2_tpu_torch.data.mappers import YOLOXDatasetMapper

        mapper = YOLOXDatasetMapper(cfg, is_train=True, seed=rank)
        loader = build_detection_train_loader(cfg, records, mapper,
                                              seed=rank,
                                              batch_size=batch_size)
        hooks = [IterationTimer(), AugDisableHook(mapper, disable_at)]

    hooks.append(PeriodicCheckpointer(checkpointer,
                                      cfg.SOLVER.CHECKPOINT_PERIOD))
    if cfg.TEST.EVAL_PERIOD > 0:
        hooks.append(EvalHook(cfg.TEST.EVAL_PERIOD,
                              build_eval_fn(cfg, eval_records)))
    # the writers last, so that the eval results of a step are written
    # with it (detectron2's hook order); rank 0's only
    if is_main_process():
        hooks.append(PeriodicWriter(
            Trainer.default_writers(cfg.OUTPUT_DIR, cfg.SOLVER.MAX_ITER)))

    fields = TRAIN_FIELDS + (("orig_hw",) if device_aug else ())
    trainer = Trainer(
        train_step, state, CudaPrefetcher(loader, device, fields),
        cfg.SOLVER.MAX_ITER, hooks=hooks, start_iter=start_iter)
    trainer.train()
    return trainer


if __name__ == "__main__":
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    logging.basicConfig(level=logging.INFO)
    main(default_argument_parser().parse_args())
