"""Training on custom COCO-format datasets (the JAX package's
``train_custom_datasets.py``):

    python -m yolov7_d2_tpu_torch.train_custom_datasets \
        --register NAME JSON IMAGE_ROOT [--register ...] \
        --config-file FILE [KEY VALUE ...]

registers the reference's five custom datasets where their files exist
(``data.catalog.register_custom_datasets``) and every ``--register``
triple, then runs ``train_det.main``.
"""

from __future__ import annotations

import logging

from yolov7_d2_tpu_torch import train_det
from yolov7_d2_tpu_torch.data.catalog import register_custom_datasets
from yolov7_d2_tpu_torch.utils.args import default_argument_parser


def main(argv=None):
    parser = default_argument_parser()
    parser.add_argument(
        "--register", nargs=3, action="append", default=[],
        metavar=("NAME", "JSON", "IMAGE_ROOT"),
    )
    args = parser.parse_args(argv)
    register_custom_datasets(tuple(tuple(r) for r in args.register))
    return train_det.main(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
