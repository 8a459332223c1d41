"""Is the card's training step bitwise repeatable, and if not, which op
parts two runs (ROADMAP.md C.14)?

For the three float32 steps of ``chip_smoke.py`` section 16
(``chip_smoke.c14_families``: YOLOX-s 640, SparseInst R-50 640 and DETR
R-50 800 at dropout 0, 4 images each, full depth and width from the seed),
it runs the step twice from the same weights and batch and compares every
module-output gradient in the order the backward computes them, every
parameter gradient and the weights after the update
(``chip_smoke.repeat_phase``). It does so in one setting a process:

* ``default``: torch's defaults (cuDNN picks its algorithms by heuristics);
* ``cudnn``: ``torch.backends.cudnn.deterministic = True``;
* ``algorithms``: ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``; the warnings
  name the ops that have no deterministic form;
* ``resize`` (SparseInst only): cuDNN deterministic throughout, the
  bilinear resizes' backward as ``F.interpolate``'s own autograd (CUDA's
  atomic adds) and as ``sparseinst._resize``'s fixed-order products.

Then it times the bf16 training step at its section's batch
(``c14_families(amp=True)``: YOLOX-s 16 images with GridMask, SparseInst
16, DETR 8), host clock over 10 steps after 3, in turns with the setting
off, on, on, off (``resize``: on is the fixed-order backward).

``--dcn`` runs, in one process, the float32 step of SparseInst R-50-DCN
(``chip_smoke.DCN_YAML``, 608 px, 4 images) twice under torch's defaults,
twice with cuDNN deterministic and twice under
``use_deterministic_algorithms(True, warn_only=True)`` (naming the ops
without a deterministic form), and raises unless the cuDNN-deterministic
runs are bitwise equal: the deformable convolution's sampling is the
port's own op, whose input gradient is summed in a fixed order
(``ops/fixed_order.grid_sample_fixed_order``). The same two runs with
``F.grid_sample``'s own backward (atomic adds) show what the repair
changed. Then it times the bf16 step of 16 images with each backward, in
turns (``F.grid_sample``, fixed order, fixed order, ``F.grid_sample``).

    python3 tools/step_repeat.py [--mode default|cudnn|algorithms|resize]
    python3 tools/step_repeat.py --dcn
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import warnings

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from yolov7_d2_tpu_torch.models.meta_arch import sparseinst  # noqa: E402
from yolov7_d2_tpu_torch.ops import deform_conv  # noqa: E402

MODES = ("default", "cudnn", "algorithms", "resize")
FIXED_ORDER_RESIZE = sparseinst._resize
FIXED_ORDER_SAMPLE = deform_conv.grid_sample


def atomic_sample(img, grid):
    """The DCN sampling with ``F.grid_sample``'s own backward."""
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def interpolate_resize(x, size, antialias: bool = False):
    """``sparseinst._resize`` with ``F.interpolate``'s own backward."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=antialias)


def step_ms(build, batch, steps=3 + 10) -> float:
    state, step = build()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3, steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (steps - 3)


def set_mode(mode: str, on: bool) -> None:
    if mode == "cudnn":
        torch.backends.cudnn.deterministic = on
    elif mode == "algorithms":
        torch.use_deterministic_algorithms(on, warn_only=True)
    elif mode == "resize":
        sparseinst._resize = FIXED_ORDER_RESIZE if on else interpolate_resize


def run_mode(mode: str) -> None:
    from yolov7_d2_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 6)
    for (name, build32, batch32, _), (_, build16, batch16, _) in zip(
            chip_smoke.c14_families(dev, gen),
            chip_smoke.c14_families(dev, gen, amp=True)):
        if mode == "resize":
            if not name.startswith("SparseInst"):
                continue
            with chip_smoke.deterministic_library():
                for on in (False, True):
                    set_mode(mode, on)
                    chip_smoke.repeat_phase(
                        dev, card, f"{name} f32 [cuDNN deterministic, "
                        "bilinear backward "
                        + ("fixed-order]" if on else "F.interpolate]"),
                        build32, batch32)
            set_mode(mode, True)
        else:
            set_mode(mode, True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                chip_smoke.repeat_phase(dev, card, f"{name} f32 [{mode}]",
                                        build32, batch32)
            ops = sorted({str(w.message).split("\n")[0] for w in caught
                          if "deterministic" in str(w.message)})
            if mode == "algorithms":
                chip_smoke.log(f"C.14 {name} [{mode}]: ops without a "
                               f"deterministic form: {ops or 'none'}")
            set_mode(mode, False)
        if mode == "default":
            continue
        # the bf16 step's cost of the setting, in turns
        turns = []
        for on in (False, True, True, False):
            set_mode(mode, on)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                turns.append((on, step_ms(build16, batch16)))
            torch.cuda.empty_cache()
        set_mode(mode, mode == "resize")
        off = [ms for o, ms in turns if not o]
        det = [ms for o, ms in turns if o]
        chip_smoke.log(
            f"C.14 {name} bf16 step of {batch16['image'].shape[0]} on "
            f"[{card}], {mode} off/on/on/off: "
            + ", ".join(f"{ms:.3f}" for _, ms in turns)
            + f" ms; on / off {sum(det) / sum(off):.4f}")


def run_dcn() -> None:
    """``--dcn``: SparseInst R-50-DCN's float32 step, twice a setting."""
    from yolov7_d2_tpu_torch.engine import build_system
    from yolov7_d2_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 6)
    cfg = chip_smoke.coco_cfg(chip_smoke.DCN_YAML, amp=False)
    batch = chip_smoke.inseg_batch(4, gen, dev, cfg.input_size[0])
    name = f"SparseInst R-50-DCN {cfg.input_size[0]} f32"

    def build_fn():
        _, state, step, _ = build_system(cfg, device=dev,
                                         seed=chip_smoke.SEED)
        return state, step

    chip_smoke.repeat_phase(dev, card, f"{name} [default]", build_fn, batch)
    with chip_smoke.deterministic_library():
        gaps = chip_smoke.repeat_phase(
            dev, card, f"{name} [cuDNN deterministic]", build_fn, batch)
        deform_conv.grid_sample = atomic_sample
        chip_smoke.repeat_phase(
            dev, card, f"{name} [cuDNN deterministic, F.grid_sample's "
            "backward]", build_fn, batch)
        deform_conv.grid_sample = FIXED_ORDER_SAMPLE
    if gaps["outputs_differ"] or gaps["params_differ"] or \
            not gaps["weights_equal"]:
        raise AssertionError(f"C.14 {name}: two cuDNN-deterministic runs "
                             f"part at {gaps['output']}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chip_smoke.repeat_phase(dev, card, f"{name} [algorithms]", build_fn,
                                batch)
    torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0] for w in caught
                  if "deterministic" in str(w.message)})
    chip_smoke.log(f"C.14 {name} [algorithms]: ops without a deterministic "
                   f"form: {ops or 'none'}")
    dcn_step_times(dev, card, gen)


def dcn_step_times(dev, card: str, gen: torch.Generator,
                   n: int = chip_smoke.TRAIN_BATCH) -> list:
    """The bf16 SparseInst R-50-DCN step of ``n`` images with
    ``F.grid_sample``'s backward and with the fixed-order one, in turns;
    returns ``[(fixed, ms), ...]``."""
    from yolov7_d2_tpu_torch.engine import build_system

    cfg = chip_smoke.coco_cfg(chip_smoke.DCN_YAML)
    batch = chip_smoke.inseg_batch(n, gen, dev, cfg.input_size[0])

    def build16():
        _, state, step, _ = build_system(cfg, device=dev,
                                         seed=chip_smoke.SEED)
        return state, step

    turns = []
    for fixed in (False, True, True, False):
        deform_conv.grid_sample = FIXED_ORDER_SAMPLE if fixed \
            else atomic_sample
        turns.append((fixed, step_ms(build16, batch)))
        torch.cuda.empty_cache()
    deform_conv.grid_sample = FIXED_ORDER_SAMPLE
    fixed_ms = [ms for f, ms in turns if f]
    atomic_ms = [ms for f, ms in turns if not f]
    chip_smoke.log(
        f"C.14 SparseInst R-50-DCN {cfg.input_size[0]} bf16 step of {n} on "
        f"[{card}], DCN backward F.grid_sample / fixed order / fixed order "
        "/ F.grid_sample: " + ", ".join(f"{ms:.3f}" for _, ms in turns)
        + f" ms; fixed / F.grid_sample {sum(fixed_ms) / sum(atomic_ms):.4f}")
    return turns


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=MODES)
    parser.add_argument("--dcn", action="store_true",
                        help="SparseInst R-50-DCN's float32 step alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("step_repeat: no CUDA device")
    if args.dcn:
        # before the first cuBLAS call: its deterministic workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        run_dcn()
        return 0
    if args.mode:
        run_mode(args.mode)
        return 0
    for mode in MODES:
        env = dict(os.environ)
        if mode == "algorithms":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        subprocess.run([sys.executable, os.path.abspath(__file__), "--mode",
                        mode], check=True, env=env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
