"""DETR-family training CLI of the port (the JAX package's
``train_transformer.py``): DETR, AnchorDETR, the other variants and
DetrSegm, whose mask terms the CLI does not train (the mapper gives no
masks, as the JAX script's ``DetrDatasetMapper`` gives none).

    python -m yolov7_d2_tpu_torch.train_transformer \
        --config-file configs/coco/detr/detr_256_6_6_r50.yaml \
        [--resume] [--num-gpus N] [KEY VALUE ...]

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
the CPU) and never falls back to the CPU. ``--num-gpus N`` (with
``--num-machines``, ``--machine-rank``, ``--dist-url`` as in ``train_det``)
runs N processes a machine, one card each over NCCL (gloo on the CPU with
``MODEL.DEVICE cpu``) in the grid of ``TPU.MESH_SHAPE``
(``train_det.rank_share``); ``SOLVER.IMS_PER_BATCH`` stays the global
batch, of which each data rank takes its share, and the step is that of
the global batch (the set criterion's normalizers summed over the data
ranks, DDP's summed gradient). Each data rank maps, shuffles and drops out
with its own seed; a model axis above 1 replicates the weights, as the
JAX script's mesh does; rank 0 writes the config, the metrics and the
checkpoints.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("yolov7_d2_tpu_torch")


def main(args):
    """Train on ``args.num_gpus * args.num_machines`` processes. In one
    process, return the ``Trainer`` (its ``storage`` holds the last
    scalars); None with more processes."""
    from yolov7_d2_tpu_torch.train_det import launch_main

    return launch_main(run, args)


def run(args):
    """The training of one process; returns its ``Trainer``."""
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
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.parallel.dist import (
        get_rank,
        get_world_size,
        is_main_process,
    )
    from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
    from yolov7_d2_tpu_torch.train.trainer import (
        IterationTimer,
        PeriodicCheckpointer,
        PeriodicWriter,
        Trainer,
    )
    from yolov7_d2_tpu_torch.train_det import rank_setup, rank_share

    cfg, device = rank_setup(args)
    grid, batch_size = rank_share(cfg, get_world_size(), get_rank())
    rank = grid.data_rank

    records = []
    for name in cfg.DATASETS.TRAIN:
        records.extend(DatasetCatalog.get(name))
    seed = max(int(cfg.SEED), 0)  # SEED=-1 means "unseeded" (d2 convention)
    _, state, train_step, fields = build_system(cfg, device=device,
                                                seed=seed)
    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    state, start_iter = checkpointer.resume_or_load(state, resume=args.resume)

    # the reference selects the DETR mapper by the architecture's name;
    # each rank draws its own crops and shuffles with its own seed
    mapper_cls = (DetrDatasetMapper
                  if "detr" in cfg.MODEL.META_ARCHITECTURE.lower()
                  else SimpleDatasetMapper)
    loader = build_detection_train_loader(
        cfg, records, mapper_cls(cfg, is_train=True, seed=rank), seed=rank,
        batch_size=batch_size, collate=stack_uint8_batch)
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
