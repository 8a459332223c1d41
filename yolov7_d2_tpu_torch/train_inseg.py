"""Instance-segmentation training CLI of the port (the JAX package's
``train_inseg.py``): SparseInst.

    python -m yolov7_d2_tpu_torch.train_inseg \
        --config-file configs/coco/sparseinst/sparse_inst_r50_base.yaml \
        [--resume] [--eval-only] [--num-gpus N] [KEY VALUE ...]

Config -> COCO records with polygon segmentations (``DATASETS.TRAIN`` from
the catalog) -> ``DarknetMosaicDatasetMapper`` with masks (the Darknet
blend mosaic where ``INPUT.MOSAIC.ENABLED``, else the config's chain) in
the threaded ``DataLoader``, batches collated by ``stack_mask_batch``
(uint8 images, ground-truth slots cut to the batch's largest count) ->
``CudaPrefetcher`` -> ``engine.build_system``'s SparseInst step (the
normalize kernel, the model, the auction matcher and mask losses, AdamW)
-> the trainer with the JAX script's hooks: timer, periodic checkpoint
(``OUTPUT_DIR/ckpt``), writers (``OUTPUT_DIR/metrics.json``). It runs on
``MODEL.DEVICE`` (``cuda`` by default, ``MODEL.DEVICE cpu`` on the CPU)
and never falls back to the CPU. ``--eval-only`` evaluates the masks of
the (resumed) model on ``DATASETS.TEST`` with ``COCOMaskEvaluator``
(:func:`build_mask_eval_fn`) on rank 0. ``--num-gpus N`` (``--num-machines``,
``--machine-rank``, ``--dist-url`` as in ``train_det``) runs N processes a
machine, one card each over NCCL (gloo on the CPU with ``MODEL.DEVICE
cpu``) in the grid of ``TPU.MESH_SHAPE`` (``train_det.rank_share``);
``SOLVER.IMS_PER_BATCH`` stays the global batch, of which each data rank
takes its share, and the step is that of the global batch (the matched
count summed over the data ranks, DDP's summed gradient). Each data rank
maps and shuffles with its own seed; a model axis above 1 replicates the
weights, as the JAX script's mesh does; rank 0 writes the config, the
metrics and the checkpoints.
"""

from __future__ import annotations

import logging
import os
import types

import numpy as np
import torch

logger = logging.getLogger("yolov7_d2_tpu_torch")


def build_mask_eval_fn(cfg, eval_records):
    """COCO mask evaluation over ``eval_records``: ``eval_fn(trainer) ->
    {metric: value}`` (``AP``, ``AP50``, ``AP75``, ``APs``, ``APm``,
    ``APl``, ``AR100`` of the ``segm`` IoU type; NaN where a bin holds no
    ground truth). The eval mapper's uint8 batch -> the model (in eval
    mode, on its device) -> ``sparseinst_postprocess`` ->
    ``upsample_masks_two_stage`` to each original image; ground-truth
    masks from the records' polygons at the original size."""
    from yolov7_d2_tpu_torch.config import SparseInstConfig
    from yolov7_d2_tpu_torch.data.loader import (
        build_detection_test_loader,
        stack_mask_batch,
    )
    from yolov7_d2_tpu_torch.data.mappers import (
        SimpleDatasetMapper,
        annotations_to_arrays,
    )
    from yolov7_d2_tpu_torch.evaluation.coco_eval import (
        COCOMaskEvaluator,
        polygons_to_mask,
    )
    from yolov7_d2_tpu_torch.models.meta_arch.sparseinst import (
        sparseinst_eval_masks,
        sparseinst_postprocess,
    )
    from yolov7_d2_tpu_torch.structures.instances import Detections

    scfg = SparseInstConfig.from_cfg(cfg)
    mapper = SimpleDatasetMapper(cfg, is_train=False)
    gts = {}
    for i, r in enumerate(eval_records):
        boxes, classes = annotations_to_arrays(r)
        masks = [polygons_to_mask(a["segmentation"], r["height"], r["width"])
                 if isinstance(a.get("segmentation"), list) and
                 a["segmentation"] else
                 np.zeros((r["height"], r["width"]), bool)
                 for a in r.get("annotations", []) if not a.get("iscrowd", 0)]
        areas = np.asarray([m.sum() for m in masks], np.float64)
        gts[int(r.get("image_id", i))] = (boxes, classes, areas, masks)

    def eval_fn(trainer):
        model = trainer.state.model
        was_training = model.training
        model.eval()
        device = next(model.parameters()).device
        evaluator = COCOMaskEvaluator(scfg.num_classes)
        loader = build_detection_test_loader(cfg, eval_records, mapper,
                                             collate=stack_mask_batch)
        try:
            for batch in loader:
                with torch.inference_mode():
                    out = model(torch.from_numpy(batch["image"]).to(device))
                    dets = sparseinst_postprocess(
                        out, scfg.cls_threshold, scfg.mask_threshold,
                        scfg.max_detections)
                for i in range(len(batch["image"])):
                    img_id = int(batch["image_id"][i])
                    oh, ow = (int(v) for v in batch["orig_hw"][i])
                    s = float(batch["scale"][i])
                    one = Detections(*(t[i] for t in (
                        dets.boxes, dets.scores, dets.classes, dets.valid,
                        dets.masks)))
                    scores, classes, boxes, masks = sparseinst_eval_masks(
                        one, scfg.input_size,
                        (min(round(oh * s), scfg.input_size[0]),
                         min(round(ow * s), scfg.input_size[1])),
                        (oh, ow), scfg.mask_threshold)
                    evaluator.add_predictions(img_id, boxes, scores, classes,
                                              masks=list(masks))
                    g_boxes, g_classes, g_areas, g_masks = gts[img_id]
                    evaluator.add_gt(img_id, g_boxes, g_classes,
                                     areas=g_areas, masks=g_masks)
        finally:
            model.train(was_training)
        results = evaluator.evaluate()
        logger.info(f"COCO segm eval: {results}")
        return results

    return eval_fn


def main(args):
    """Train (or with ``--eval-only`` evaluate) on ``args.num_gpus *
    args.num_machines`` processes. In one process, return the ``Trainer``
    (its ``storage`` holds the last scalars) or the eval dict; None with
    more processes."""
    from yolov7_d2_tpu_torch.train_det import launch_main

    return launch_main(run, args)


def run(args):
    """The training of one process; returns its ``Trainer`` (with
    ``--eval-only``, the eval dict on rank 0 and None on the others)."""
    from yolov7_d2_tpu_torch.config import SparseInstConfig
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.data.loader import (
        CudaPrefetcher,
        build_detection_train_loader,
        stack_mask_batch,
    )
    from yolov7_d2_tpu_torch.data.mappers import DarknetMosaicDatasetMapper
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.parallel.dist import (
        get_rank,
        get_world_size,
        is_main_process,
        synchronize,
    )
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
    from yolov7_d2_tpu_torch.train.trainer import (
        IterationTimer,
        PeriodicCheckpointer,
        PeriodicWriter,
        Trainer,
    )
    from yolov7_d2_tpu_torch.train_det import rank_setup, rank_share
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    arch = setup_cfg(args).MODEL.META_ARCHITECTURE
    if arch != "SparseInst":
        raise NotImplementedError(
            f"train_inseg trains SparseInst, not {arch!r} (the JAX script's "
            "family)")
    cfg, device = rank_setup(args)
    grid, batch_size = rank_share(cfg, get_world_size(), get_rank())
    rank = grid.data_rank

    records = []
    for name in cfg.DATASETS.TRAIN:
        records.extend(DatasetCatalog.get(name))
    seed = max(int(cfg.SEED), 0)  # SEED=-1 means "unseeded" (d2 convention)
    _, state, train_step, fields = build_system(
        SparseInstConfig.from_cfg(cfg), device=device, seed=seed)
    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    state, start_iter = checkpointer.resume_or_load(state, resume=args.resume)
    if args.eval_only:
        results = None
        if is_main_process():
            eval_records = []
            for name in cfg.DATASETS.TEST:
                eval_records.extend(DatasetCatalog.get(name))
            results = build_mask_eval_fn(cfg, eval_records)(
                types.SimpleNamespace(state=state))
            print(results)
        synchronize()
        return results

    # the reference inseg path trains through the blend mosaic
    # (INPUT.MOSAIC.ENABLED), else the config's plain chain; each rank
    # draws its own mosaics and shuffles with its own seed
    mapper = DarknetMosaicDatasetMapper(cfg, is_train=True, with_masks=True,
                                        seed=rank)
    loader = build_detection_train_loader(cfg, records, mapper, seed=rank,
                                          batch_size=batch_size,
                                          collate=stack_mask_batch)
    hooks = [
        IterationTimer(),
        PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD),
    ]
    if is_main_process():
        hooks.append(PeriodicWriter(Trainer.default_writers(
            cfg.OUTPUT_DIR, cfg.SOLVER.MAX_ITER)))
    trainer = Trainer(train_step, state,
                      CudaPrefetcher(loader, device, fields),
                      cfg.SOLVER.MAX_ITER, hooks=hooks, start_iter=start_iter)
    trainer.train()
    return trainer


if __name__ == "__main__":
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    logging.basicConfig(level=logging.INFO)
    main(default_argument_parser().parse_args())
