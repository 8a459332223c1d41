"""Training on custom COCO-format datasets (the JAX package's
``train_custom_datasets.py``):

    python -m yolov7_d2_tpu_torch.train_custom_datasets \
        --register NAME JSON IMAGE_ROOT [--register ...] \
        --config-file FILE [--num-gpus N ...] [KEY VALUE ...]

registers the reference's five custom datasets where their files exist
(``data.catalog.register_custom_datasets``) and every ``--register``
triple, then runs ``train_det.run``. The catalog belongs to its process,
and a ``spawn``-ed rank starts with it empty, so every rank registers for
itself (detectron2's ``main(args)``).
"""

from __future__ import annotations

import logging

from yolov7_d2_tpu_torch import train_det
from yolov7_d2_tpu_torch.data.catalog import register_custom_datasets
from yolov7_d2_tpu_torch.utils.args import default_argument_parser


def run(args):
    """One rank: register the datasets, then train (``train_det.run``)."""
    register_custom_datasets(tuple(tuple(r) for r in args.register))
    return train_det.run(args)


def main(argv=None):
    parser = default_argument_parser()
    parser.add_argument(
        "--register", nargs=3, action="append", default=[],
        metavar=("NAME", "JSON", "IMAGE_ROOT"),
    )
    return train_det.launch_main(run, parser.parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
