"""``train_inseg`` and ``train_transformer`` with ``--num-gpus 2 MODEL.DEVICE
cpu``: two gloo ranks through each CLI's ``main`` on the mini-COCO
fixtures of ``tests/test_torch_port_inseg_feed.py`` and
``tests/test_torch_port_detr_feed.py`` (64 px, one image a rank, the
records in order and the mosaic and crop off, so that both ranks see the
same image at a step). Rank 0 alone writes ``metrics.json`` (one line, at
the last step) and the checkpoints; the logged matched count is the
global one, twice the count of the step's image; each rank registers the
calling process's datasets (``train_det.launch_main``). The spawn is
bounded by the ranks' own short run; a rank that fails fails the test.
"""

import json

import numpy as np
import torch

from _torch_port_helpers import opts_list
from test_torch_port_detr_feed import DETR_YAML
from test_torch_port_detr_feed import TINY as DETR_TINY
from test_torch_port_inseg_feed import BASE_YAML
from test_torch_port_inseg_feed import TINY as INSEG_TINY
from test_torch_port_inseg_feed import write_mini_coco_segm
from yolov7_d2_tpu_torch import train_inseg, train_transformer
from yolov7_d2_tpu_torch.data.catalog import (
    DatasetCatalog,
    register_coco_instances,
)
from yolov7_d2_tpu_torch.train.checkpoint import Checkpointer
from yolov7_d2_tpu_torch.utils.args import default_argument_parser

STEPS = 2


def _run(cli, yaml, tiny, tmp_path, name, count_key, **more):
    js, root = write_mini_coco_segm(tmp_path / "data", n=4)
    register_coco_instances(name, {}, js, root)
    try:
        out = tmp_path / "out"
        opts = dict(tiny, **{
            "MODEL.DEVICE": "cpu", "SOLVER.MAX_ITER": STEPS,
            "SOLVER.CHECKPOINT_PERIOD": 1, "DATALOADER.SHUFFLE": False,
            "DATASETS.TRAIN": f"('{name}',)",
            "DATASETS.TEST": f"('{name}',)", "OUTPUT_DIR": str(out)},
            **more)
        args = default_argument_parser().parse_args(
            ["--config-file", yaml, "--num-gpus", "2"] + opts_list(opts))
        assert cli.main(args) is None
        records = DatasetCatalog.get(name)
    finally:
        DatasetCatalog.remove(name)
    lines = [json.loads(line) for line in open(out / "metrics.json")]
    assert [r["iteration"] for r in lines] == [STEPS], lines
    last = lines[-1]
    assert np.isfinite(last["total_loss"]) and last["grad_norm"] > 0
    # one image a rank, the same on both: the global count is twice its
    image = records[STEPS - 1]
    want = 2 * sum(not a.get("iscrowd", 0) for a in image["annotations"])
    assert last[count_key] == want, (last[count_key], want)
    assert Checkpointer(str(out / "ckpt")).steps() == list(
        range(1, STEPS + 1))
    blob = Checkpointer(str(out / "ckpt")).load()
    assert blob["step"] == STEPS
    assert all(torch.isfinite(v).all() for v in blob["model"].values()
               if v.is_floating_point())
    return last


def test_train_inseg_on_two_gloo_ranks(tmp_path):
    last = _run(train_inseg, BASE_YAML, INSEG_TINY, tmp_path,
                "inseg_two_ranks", "num_inst",
                **{"INPUT.MOSAIC.ENABLED": False})
    assert last["match_iters"] >= 1


def test_train_transformer_on_two_gloo_ranks(tmp_path):
    last = _run(train_transformer, DETR_YAML, DETR_TINY, tmp_path,
                "detr_two_ranks", "num_matched",
                **{"INPUT.CROP.ENABLED": False})
    assert last["aux0_num_matched"] == last["num_matched"]
