"""Shared argument parser of the entry points, and the config they set up
(a copy of ``yolov7_d2_tpu/utils/args.py``)."""

from __future__ import annotations

import argparse


def default_argument_parser(epilog: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(epilog=epilog)
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument(
        "--num-gpus", "--num-chips", type=int, default=1, dest="num_gpus",
        help="chips per machine (name kept for reference CLI parity)",
    )
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument(
        "opts", default=None, nargs=argparse.REMAINDER,
        help="'KEY VALUE' pairs overriding config",
    )
    return parser


def setup_cfg(args):
    from yolov7_d2_tpu_torch.config.defaults import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg

