"""Where the 2-rank step parts from the one-process step, on one card.

Runs ``chip_smoke.py``'s check (a) -- the bare YOLOX-s 640 train step in
float32 (TF32 off), 2 gloo ranks of 2 images on one card against one
process on the 4, 2 steps, here with the one process following its own
updates -- three times in one process:

1. with ``SyncBatchNorm2d``'s elementwise path (the CPU's, forced on the
   card in the ranks);
2. with its fused CUDA path;
3. with the fused path at a learning rate of 0, so that both runs hold the
   initial weights at every step, beside a float64 forward of those
   weights in one process (train mode, the same 4 images): how far each
   float32 run's head outputs are from it.

Then two controls: the one-process run against itself (the card's
run-to-run spread over the same 2 steps), and the weights after one step
on 2 ranks against one process, parameter by parameter (the tensors that
differ most, of their largest magnitude).

For each step it logs the loss and gradient-norm gaps, how far the head
outputs differ, in how many anchors the loss's top-K prefilter of each
run's outputs keeps apart (the one process takes the ranks' selection),
and in how many anchors the SimOTA assignment recomputed from each run's
outputs differs among those kept.

    python3 tools/sync_step_gap.py

With ``--repeat N`` it runs instead ``chip_smoke.py``'s check (a) as the
smoke runs it, N times in one process, and counts the runs that fail:
how often the card's run-to-run spread moves the check.

    python3 tools/sync_step_gap.py --repeat 12
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from yolov7_d2_tpu_torch.parallel import dryrun  # noqa: E402
from yolov7_d2_tpu_torch.parallel.norm_sync import SyncBatchNorm2d  # noqa: E402

TRAIN_STEPS = dryrun.train_steps


def elementwise_train_steps(*args, **kwargs):
    """``train_steps`` with the elementwise ``SyncBatchNorm2d`` on CUDA."""
    SyncBatchNorm2d._forward_fused = SyncBatchNorm2d._forward_elementwise
    TRAIN_STEPS(*args, **kwargs)


@torch.no_grad()
def float64_outputs(dev, cfg, batches):
    """The head outputs of the initial weights in float64, train mode,
    one process, for each batch."""
    from yolov7_d2_tpu_torch.engine import build_yolox_system

    model, _, _ = build_yolox_system(cfg, device=dev, seed=chip_smoke.SEED)
    model = model.double().train()
    outs = []
    for batch in batches:
        # YOLOX-s casts the uint8 batch without scaling (NORMALIZE_INPUT
        # off): YOLOX.forward's float path, in float64
        x = batch["image"].to(dev).permute(0, 3, 1, 2).double()
        feats = model.backbone(x)
        head = model.head(model.neck([feats[f] for f in model.in_features]))
        outs.append(head["outputs"])
    return outs


def one_process_twice(dev, cfg, batches) -> None:
    """The one-process float32 step from the same weights twice: gradient
    norms and head outputs, step by step."""
    from yolov7_d2_tpu_torch.engine import build_yolox_system

    runs = []
    for _ in range(2):
        _, state, step = build_yolox_system(cfg, device=dev,
                                            seed=chip_smoke.SEED)
        heads, norms = [], []
        state.model.register_forward_hook(
            lambda module, args, head: heads.append(
                head["outputs"].detach().float()))
        for batch in batches:
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            norms.append(float(m["grad_norm"]))
        runs.append((heads, norms))
    for i in range(len(batches)):
        chip_smoke.log(
            f"one process twice, step {i}: grad_norm "
            f"{chip_smoke.relative_gap(runs[1][1][i], runs[0][1][i]):.2e}, "
            f"head outputs {gap(runs[1][0][i], runs[0][0][i]):.2e} of max")


def weights_after_one_step(dev, cfg, batch, top: int = 8) -> None:
    """The parameters after one step on 2 gloo ranks against one process:
    the tensors whose largest difference is the largest share of their
    largest magnitude, then the three that hold the most of the summed
    squared difference."""
    import shutil

    from yolov7_d2_tpu_torch.engine import build_yolox_system
    from yolov7_d2_tpu_torch.parallel.launch import launch

    out = os.path.join(REPO, "build", "sync_step_gap")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    try:
        launch(TRAIN_STEPS, 2, args=(out, cfg, [batch], str(dev)),
               backend="gloo")
    finally:
        del os.environ["NVIDIA_TF32_OVERRIDE"]
    ranks = torch.load(os.path.join(out, "rank0.pt"), weights_only=True)
    shutil.rmtree(out, ignore_errors=True)
    model, state, step = build_yolox_system(cfg, device=dev,
                                            seed=chip_smoke.SEED)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step(state, {k: v.to(dev) for k, v in batch.items()})
    rows, total = [], 0.0
    for name, want in model.named_parameters():
        want = want.detach()
        got = ranks["model"][name].to(dev).double()
        want = want.double()
        diff = (got - want).abs()
        moved = (want - init[name].double()).abs().max()
        sq = float(diff.square().sum())
        total += sq
        rows.append((float(diff.max() / want.abs().max().clamp(min=1e-30)),
                     name, sq, float(moved / want.abs().max().clamp(
                         min=1e-30))))
    rows.sort(reverse=True)
    by_share = sorted(rows, key=lambda r: -r[2])[:3]
    for rel, name, sq, moved in rows[:top] + by_share:
        chip_smoke.log(
            f"after one step, {name}: 2 ranks / one process differ by "
            f"{rel:.2e} of its max ({sq / max(total, 1e-300):.1%} of the "
            f"squared difference); the step moved it by {moved:.2e}")


def gap(a, b) -> float:
    """max |a - b| over max |b|."""
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def repeat_check(dev, card: str, cfg, runs: int) -> int:
    """``chip_smoke.sync_phase`` as the smoke calls it, ``runs`` times;
    returns the number of runs that failed."""
    failed = 0
    for r in range(runs):
        chip_smoke.log(f"--- check (a), run {r + 1} of {runs}")
        try:
            chip_smoke.sync_phase(dev, card, cfg)
        except AssertionError as e:
            chip_smoke.log(f"run {r + 1} failed: {e}")
            failed += 1
    chip_smoke.log(f"check (a): {failed} of {runs} runs failed")
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("sync_step_gap: needs a CUDA card")
    import argparse

    from yolov7_d2_tpu_torch.config import YoloxConfig
    from yolov7_d2_tpu_torch.kernels import build

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeat", type=int, default=0,
                        help="run chip_smoke.py's check (a) this many times")
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    chip_smoke.log(f"card: {card}")
    build.load_library()
    dev = torch.device("cuda", 0)
    cfg = YoloxConfig()
    if args.repeat:
        return 1 if repeat_check(dev, card, cfg, args.repeat) else 0
    failed = False
    for name, fn, run_cfg in (
            ("elementwise", elementwise_train_steps, cfg),
            ("fused", TRAIN_STEPS, cfg),
            ("fused, learning rate 0", TRAIN_STEPS,
             dataclasses.replace(cfg, base_lr=0.0))):
        chip_smoke.log(f"--- SyncBatchNorm2d {name} path in the ranks")
        dryrun.train_steps = fn
        try:
            batches, heads, ranks = chip_smoke.sync_phase(
                dev, card, run_cfg, follow_ranks=False)
        except AssertionError as e:
            chip_smoke.log(f"{name}: {e}")
            failed = True
            continue
        finally:
            dryrun.train_steps = TRAIN_STEPS
        if run_cfg.base_lr != 0.0:
            continue
        ref = float64_outputs(dev, dataclasses.replace(run_cfg, amp=False),
                              batches)
        for i, want in enumerate(ref):
            one = heads[i]["outputs"]
            other = torch.cat([r[i] for r in ranks]).to(dev)
            chip_smoke.log(
                f"step {i}, initial weights: head outputs from float64 "
                f"(of its max): one process {gap(one, want):.2e}, 2 ranks "
                f"{gap(other, want):.2e}; between them {gap(other, one):.2e}")
    chip_smoke.log("--- controls")
    fcfg = dataclasses.replace(cfg, amp=False)
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    one_process_twice(dev, fcfg, batches)
    del os.environ["NVIDIA_TF32_OVERRIDE"]
    weights_after_one_step(dev, fcfg, batches[0])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
