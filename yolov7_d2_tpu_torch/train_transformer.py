"""DETR-family training CLI of the port (the JAX package's
``train_transformer.py``): DETR and AnchorDETR.

    python -m yolov7_d2_tpu_torch.train_transformer \
        --config-file configs/coco/detr/detr_256_6_6_r50.yaml \
        [--resume] [KEY VALUE ...]

Config -> COCO records (``DATASETS.TRAIN`` from the catalog) ->
``DetrDatasetMapper`` where "detr" is in the architecture's name (flip,
``ResizeShortestEdge``, half the time the crop branch where
``INPUT.CROP.ENABLED``), else ``SimpleDatasetMapper``, in the threaded
``DataLoader``, batches collated with uint8 images
(``stack_uint8_batch``) -> ``CudaPrefetcher`` -> ``engine.build_system``'s
step (the normalize kernel, the model, the set criterion on the batched
auction, AdamW with ``BACKBONE_MULTIPLIER``) -> the trainer with the JAX
script's hooks: timer, periodic checkpoint (``OUTPUT_DIR/ckpt``), writers
(``OUTPUT_DIR/metrics.json``). No evaluation, as the JAX script runs none.
It runs on ``MODEL.DEVICE`` (``cuda`` by default, ``MODEL.DEVICE cpu`` on
the CPU) and never falls back to the CPU. One process: ``--num-gpus``
above 1 raises (multi-GPU DETR, the matched count all-reduced, is
ROADMAP.md Queue A.6d).
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("yolov7_d2_tpu_torch")


def main(args):
    """Train in this process; returns the ``Trainer`` (its ``storage``
    holds the last scalars). More than one process raises."""
    if args.num_gpus * args.num_machines > 1:
        raise NotImplementedError(
            "train_transformer runs one process: multi-GPU DETR training "
            "(num_boxes all-reduced over the ranks, --num-gpus) is not "
            "ported yet (ROADMAP.md Queue A.6d)")
    return run(args)


def run(args):
    from yolov7_d2_tpu_torch.data.catalog import DatasetCatalog
    from yolov7_d2_tpu_torch.data.loader import (
        CudaPrefetcher,
        build_detection_train_loader,
        stack_uint8_batch,
    )
    from yolov7_d2_tpu_torch.data.mappers import (
        DetrDatasetMapper,
        SimpleDatasetMapper,
    )
    from yolov7_d2_tpu_torch.engine import build_system, resolve_device
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
    from yolov7_d2_tpu_torch.train.trainer import (
        IterationTimer,
        PeriodicCheckpointer,
        PeriodicWriter,
        Trainer,
    )
    from yolov7_d2_tpu_torch.utils.args import setup_cfg

    cfg = setup_cfg(args)
    device = resolve_device(cfg.MODEL.DEVICE)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())

    records = []
    for name in cfg.DATASETS.TRAIN:
        records.extend(DatasetCatalog.get(name))
    seed = max(int(cfg.SEED), 0)  # SEED=-1 means "unseeded" (d2 convention)
    _, state, train_step, fields = build_system(cfg, device=device,
                                                seed=seed)
    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    state, start_iter = checkpointer.resume_or_load(state, resume=args.resume)

    # the reference selects the DETR mapper by the architecture's name
    mapper_cls = (DetrDatasetMapper
                  if "detr" in cfg.MODEL.META_ARCHITECTURE.lower()
                  else SimpleDatasetMapper)
    loader = build_detection_train_loader(cfg, records,
                                          mapper_cls(cfg, is_train=True),
                                          collate=stack_uint8_batch)
    hooks = [
        IterationTimer(),
        PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD),
        PeriodicWriter(Trainer.default_writers(cfg.OUTPUT_DIR,
                                               cfg.SOLVER.MAX_ITER)),
    ]
    trainer = Trainer(train_step, state,
                      CudaPrefetcher(loader, device, fields),
                      cfg.SOLVER.MAX_ITER, hooks=hooks, start_iter=start_iter)
    trainer.train()
    return trainer


if __name__ == "__main__":
    from yolov7_d2_tpu_torch.utils.args import default_argument_parser

    logging.basicConfig(level=logging.INFO)
    main(default_argument_parser().parse_args())
