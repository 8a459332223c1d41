#!/usr/bin/env python3
"""Which yaml files under ``configs/`` the PyTorch port builds, and with
``--step``, which take a train step.

    python3 tools/config_sweep_torch_port.py [--json PATH]
    python3 tools/config_sweep_torch_port.py --step [--device cpu|cuda]
        [--json PATH] [YAML ...]
    python3 tools/config_sweep_torch_port.py --export [--device cpu|cuda]
        [--json PATH]

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

``--step`` runs ``yolov7_d2_tpu_torch.zoo_step.step_sweep`` instead: each
yaml (or each one given, as paths) built by ``engine.build_system`` on
``--device`` (the card by default) at its full width and depth, 64 px (128
with BiFPN), and one train step taken on a synthetic image, as the JAX
``tests/test_config_zoo.py:29`` does; a line a yaml, then ``N of M yamls
took a step``. Any exception is a fault and ends the run non-zero. On the
CPU all 109 take some minutes; ``chip_smoke.py`` runs it on the card.

``--export`` runs ``zoo_step.export_sweep``: the first yaml of each
meta-architecture built as ``--step`` builds it (64 px, AMP off) and
exported through ``deploy/export.export_inference_fn`` into a temporary
directory, loaded back and run against the model; a line an architecture
(the program's gap to the model, or the exception that stopped the
export), then ``N of M architectures export``, non-zero if one failed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from yolov7_d2_tpu_torch.engine import (  # noqa: E402
    config_from_yaml,
    resolve_device,
)
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
    parser.add_argument("--step", action="store_true",
                        help="take one train step of each yaml")
    parser.add_argument("--device", default="cuda",
                        help="the --step sweep's device (default: cuda)")
    parser.add_argument("yamls", nargs="*",
                        help="the --step sweep's yaml files (default: all)")
    parser.add_argument("--export", action="store_true",
                        help="export one yaml of each architecture")
    args = parser.parse_args()
    if args.step:
        return step_main(args)
    if args.export:
        return export_main(args)
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


def step_main(args) -> int:
    from yolov7_d2_tpu_torch.zoo_step import step_sweep

    configs = REPO / "configs"
    paths = [Path(p).resolve() for p in args.yamls]
    total = len(paths) or len(list(configs.rglob("*.yaml")))
    rows = step_sweep(configs, resolve_device(args.device), paths)
    print(f"{len(rows)} of {total} yamls took a step")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def export_main(args) -> int:
    import tempfile

    from yolov7_d2_tpu_torch.zoo_step import export_sweep

    with tempfile.TemporaryDirectory() as out:
        rows = export_sweep(REPO / "configs", resolve_device(args.device),
                            out)
    failed = [r for r in rows if "error" in r]
    print(f"{len(rows) - len(failed)} of {len(rows)} architectures export")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
