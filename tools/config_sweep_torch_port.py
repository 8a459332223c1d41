#!/usr/bin/env python3
"""Which yaml files under ``configs/`` the PyTorch port builds.

    python3 tools/config_sweep_torch_port.py [--json PATH]

Each yaml is merged into the port's ``get_cfg`` as the entry points merge
it, turned into its architecture's config dataclass
(``engine.config_from_yaml``) and built by ``models.build.build_model`` on
the CPU, full width and depth, with the builders' seeded weights.
Prints one line a yaml (built: the parameter and BatchNorm-statistic
counts; else the ``NotImplementedError`` naming its ROADMAP.md item) and
the totals. Any other exception is a fault and ends the run with a
non-zero code. Runs no forward, needs no card and imports no JAX (the
counts against the JAX models are held by ``tests/
test_torch_port_backbone_zoo.py``, ``test_torch_port_detr_variants.py``,
``test_torch_port_dcn.py``, ``test_torch_port_dla.py``,
``test_torch_port_solov2.py``, ``test_torch_port_yolomask.py``,
``test_torch_port_detr_segm.py`` and the earlier families' tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from yolov7_d2_tpu_torch.engine import config_from_yaml  # noqa: E402
from yolov7_d2_tpu_torch.models import build  # noqa: E402
from yolov7_d2_tpu_torch.models.meta_arch import (  # noqa: E402, F401
    detr_variants,
)


def sweep(paths):
    """[(yaml, parameters or None, statistics or None, message)]."""
    rows = []
    for path in paths:
        rel = str(path.relative_to(REPO / "configs"))
        try:
            model = build.build_model(config_from_yaml(path), "cpu")
        except NotImplementedError as e:
            rows.append((rel, None, None, str(e)))
            continue
        stats = sum(v.numel() for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var")))
        rows.append((rel, sum(p.numel() for p in model.parameters()),
                     stats, type(model).__name__))
        del model
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args()
    torch.set_grad_enabled(False)
    paths = sorted((REPO / "configs").rglob("*.yaml"))
    rows = sweep(paths)
    for rel, params, stats, msg in rows:
        if params is None:
            print(f"raises  {rel}: {msg}")
        else:
            print(f"builds  {rel}: {msg}, {params} parameters, {stats} "
                  "BatchNorm statistics")
    built = sum(r[1] is not None for r in rows)
    print(f"{built} of {len(rows)} yaml files build; {len(rows) - built} "
          "raise NotImplementedError")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([dict(zip(("yaml", "parameters", "statistics",
                                 "message"), r)) for r in rows], f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
