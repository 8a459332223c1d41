"""One train step of a yaml of ``configs/`` at its full width and depth,
and the sweep of every yaml: the port's counterpart of the JAX package's
``tests/test_config_zoo.py:29`` (``test_yaml_runs_one_jitted_train_step``)
and of its batch builder ``tests/_synth_batch.py``.

Each yaml is merged into ``get_cfg`` as the entry points merge it, then
set to 64 px (128 px where the neck is BiFPN, whose stride-128 level
needs it), 8 boxes an image and AMP off, exactly as the JAX test does;
``engine.build_system`` builds the model, its state and its step on the
device, and one step runs on a synthetic batch of one image with the
fields the system asks for (:func:`synth_batch`). The step must give a
finite ``total_loss`` and move the step counter. ``python3
tools/config_sweep_torch_port.py --step`` runs the sweep; ``chip_smoke.py``
runs it on the card.
"""

from __future__ import annotations

import gc
import math
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

from yolov7_d2_tpu_torch.config.defaults import get_cfg
from yolov7_d2_tpu_torch.engine import build_system, config_from_cfg

# a yaml that neither package runs as written (ROADMAP C.31): its four
# EFFICIENTNET.FEATURE_INDICES name three taps; the sweep runs it with the
# four-tap indices that chip_smoke.py's section 19 gives it
OVERRIDES = {"wearmask/efficient_b2.yaml":
             ["MODEL.EFFICIENTNET.FEATURE_INDICES", [4, 7, 15, 22]]}


def synth_batch(fields: Sequence[str], b: int = 2, g: int = 4, s: int = 64,
                num_keypoints: int = 17, num_classes: int = 80,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A gray batch with one 32 px box an image (the JAX
    ``tests/_synth_batch.py``), keyed by ``fields``: ``image`` uint8 [b, s,
    s, 3] of 114 (the JAX float batch's values; a uint8 image goes through
    the normalize kernel where a family's head takes it), ``gt_boxes``,
    ``gt_classes`` (1, or 0 for a model of one class: the JAX batch's 1
    is out of range there, where JAX's gather clamps it and torch's
    raises, ROADMAP C.42), ``gt_valid`` (the first slot); ``gt_masks`` uint8
    [b, g, s, s] (the box's square), ``gt_keypoints`` [b, g, P, 3] (five
    visible), ``gt_sem_seg`` int32 [b, s, s] (class 1 in the square)."""
    dev = torch.device(device)
    valid = torch.zeros((b, g), dtype=torch.bool)
    valid[:, 0] = True
    batch = {
        "image": torch.full((b, s, s, 3), 114, dtype=torch.uint8),
        "gt_boxes": torch.tensor([8.0, 8.0, 40.0, 40.0]).expand(
            b, g, 4).contiguous(),
        "gt_classes": torch.full((b, g), min(1, num_classes - 1),
                                 dtype=torch.int32),
        "gt_valid": valid,
    }
    if "gt_masks" in fields:
        masks = torch.zeros((b, g, s, s), dtype=torch.uint8)
        masks[:, 0, 8:40, 8:40] = 1
        batch["gt_masks"] = masks
    if "gt_keypoints" in fields:
        kpts = torch.zeros((b, g, num_keypoints, 3))
        kpts[:, 0, :, :2] = 20.0
        kpts[:, 0, :5, 2] = 2.0
        batch["gt_keypoints"] = kpts
    if "gt_sem_seg" in fields:
        sem = torch.zeros((b, s, s), dtype=torch.int32)
        sem[:, 8:40, 8:40] = 1
        batch["gt_sem_seg"] = sem
    return {k: v.to(dev) for k, v in batch.items() if k in fields}


def step_cfg(path, rel: str = ""):
    """The merged ``CfgNode`` of the yaml ``path`` set up for the step;
    ``rel`` its path under ``configs/`` (for :data:`OVERRIDES`)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(path))
    cfg.merge_from_list(list(OVERRIDES.get(rel, [])))
    size = 128 if cfg.MODEL.YOLO.NECK.TYPE == "bifpn" else 64
    cfg.INPUT.INPUT_SIZE = [size, size]
    cfg.MODEL.YOLO.MAX_BOXES_NUM = 8
    cfg.SOLVER.AMP.ENABLED = False
    return cfg, size


def take_step(path, device, rel: str = "") -> dict:
    """Build the yaml's system on ``device`` and take one step; returns
    the yaml's row: architecture, size, parameters, loss, seconds."""
    t0 = time.perf_counter()
    cfg, size = step_cfg(path, rel)
    model, state, train_step, fields = build_system(cfg, device=device,
                                                    seed=0)
    params = sum(p.numel() for p in model.parameters())
    batch = synth_batch(fields, b=1, s=size, device=device,
                        num_classes=config_from_cfg(cfg).num_classes)
    state, metrics = train_step(state, batch)
    loss = float(metrics["total_loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{rel or path}: total_loss {loss}")
    if state.step != 1:
        raise AssertionError(f"{rel or path}: step counter {state.step}")
    return {"yaml": rel or str(path), "arch": cfg.MODEL.META_ARCHITECTURE,
            "px": size, "parameters": params, "total_loss": loss,
            "seconds": time.perf_counter() - t0,
            "override": rel in OVERRIDES}


def step_sweep(configs: Path, device, paths: Iterable[Path] = (),
               log: Callable[[str], None] = print) -> List[dict]:
    """:func:`take_step` for each yaml of ``paths`` (every yaml under
    ``configs`` when empty), logging a line a yaml; any exception ends the
    sweep."""
    rows = []
    for path in sorted(paths or Path(configs).rglob("*.yaml")):
        rel = str(Path(path).relative_to(configs))
        row = take_step(path, device, rel)
        gc.collect()  # the system's reference cycles, before the next one
        rows.append(row)
        log(f"step {rel}: {row['arch']} at {row['px']} px, "
            f"{row['parameters']} parameters, total_loss "
            f"{row['total_loss']:.6g}, {row['seconds']:.2f} s"
            + (" (C.31: MODEL.EFFICIENTNET.FEATURE_INDICES [4, 7, 15, 22])"
               if row["override"] else ""))
    return rows


def export_one(path, device, out_dir: str, rel: str = "") -> dict:
    """Build the yaml as :func:`step_cfg` sets it up (eval mode, weights
    from seed 0), export its forward on a float32 NHWC image of 114 through
    ``deploy/export.export_inference_fn``, load the program back and run
    it; returns the row: architecture, size, seconds, and the largest gap
    of the program's outputs to the model's over their largest magnitude
    (at least 1)."""
    from yolov7_d2_tpu_torch.deploy.export import (
        export_inference_fn,
        load_program,
    )
    from yolov7_d2_tpu_torch.deploy.quantize import tree_leaves
    from yolov7_d2_tpu_torch.models.build import build_model

    t0 = time.perf_counter()
    cfg, size = step_cfg(path, rel)
    model = build_model(config_from_cfg(cfg), device)
    paths = export_inference_fn(model, (1, size, size, 3), out_dir)
    program = load_program(paths["program"])
    image = torch.full((1, size, size, 3), 114.0, device=device)
    with torch.no_grad():
        want = tree_leaves(model(image))
        got = tree_leaves(program.module()(image))
    if len(got) != len(want):
        raise AssertionError(f"{rel or path}: {len(got)} outputs, the "
                             f"model {len(want)}")
    gap = 0.0
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            if g != w:
                raise AssertionError(f"{rel or path}: output {g!r}, the "
                                     f"model {w!r}")
        elif w.numel():
            gap = max(gap, float((g.float() - w.float()).abs().max())
                      / max(1.0, float(w.float().abs().max())))
    return {"yaml": rel or str(path), "arch": cfg.MODEL.META_ARCHITECTURE,
            "px": size, "outputs": len(want), "gap": gap,
            "seconds": time.perf_counter() - t0}


def export_sweep(configs: Path, device, out_dir: str,
                 log: Callable[[str], None] = print) -> List[dict]:
    """:func:`export_one` for the first yaml (in path order) of each
    meta-architecture under ``configs``; a yaml that fails gives a row
    with its exception's text (``error``) and the sweep goes on."""
    first = {}
    for path in sorted(Path(configs).rglob("*.yaml")):
        cfg, _ = step_cfg(path, str(path.relative_to(configs)))
        first.setdefault(cfg.MODEL.META_ARCHITECTURE, path)
    rows = []
    for arch, path in sorted(first.items()):
        rel = str(Path(path).relative_to(configs))
        try:
            row = export_one(path, device, str(Path(out_dir) / arch), rel)
            log(f"export {rel}: {arch} at {row['px']} px, {row['outputs']} "
                f"outputs, gap {row['gap']:.3g}, {row['seconds']:.2f} s")
        except Exception as exc:  # noqa: BLE001 - logged and reported
            row = {"yaml": rel, "arch": arch,
                   "error": f"{type(exc).__name__}: {exc}"}
            log(f"export {rel}: {arch} FAILED: {row['error'][:400]}")
        gc.collect()
        rows.append(row)
    return rows
