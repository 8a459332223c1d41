#!/usr/bin/env python3
"""Where the time of the PyTorch port's YOLOX-s serving path goes, on one
CUDA card.

    python3 tools/profile_torch_port.py

Full-width YOLOX-s at 640, bf16, random weights from seed 0, uint8 batches
already on the card. For each batch size it prints e2e (``predict_batch``),
forward-only and tail (``postprocess``) milliseconds by CUDA events. Then it
traces three e2e calls of the largest batch with torch.profiler and prints
the device's busy share of that window, the device time by operator group
(convolution, batch norm, SiLU, concat, ...) and the top kernels by name.
Every line carries the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from yolov7_d2_tpu_torch.config import YoloxConfig  # noqa: E402
from yolov7_d2_tpu_torch.predictor import Predictor  # noqa: E402

BATCHES = (1, 8, 32, 128)
TRACED_CALLS = 3
# kernel name -> group; the first pattern that matches wins
GROUPS = (
    ("normalize kernel (K2)", r"normalize_kernel"),
    ("NMS kernel (K1)", r"nms_kernel"),
    ("batch norm", r"batch_norm|bn_fw"),
    ("SiLU", r"silu"),
    ("concat", r"CatArray|cat_"),
    ("max-pool", r"max_pool"),
    ("upsample", r"upsample"),
    ("sort / top-k", r"[Ss]ort|[Tt]op[Kk]|radix|bitonic"),
    # cuDNN runs the 1x1 convolutions as cuBLAS GEMMs (nvjet kernels)
    ("convolution", r"conv|xmma|implicit_gemm|fprop|cudnn|sm90_|cutlass|"
                    r"nvjet"),
    ("residual add", r"CUDAFunctor_add"),
    ("casts and copies", r"copy|cast"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def group_of(kernel: str) -> str:
    for name, pattern in GROUPS:
        if re.search(pattern, kernel):
            return name
    return "other elementwise and reductions"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_port: no CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    predictor = Predictor(YoloxConfig(), device=dev, seed=0)
    gen = torch.Generator().manual_seed(0)

    for bs in BATCHES:
        x = torch.randint(0, 256, (bs, 640, 640, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        e2e = cuda_ms(lambda: predictor.predict_batch(x))
        fwd = cuda_ms(lambda: predictor.forward(x))
        head = predictor.forward(x)
        tail = cuda_ms(lambda: predictor.postprocess(head))
        print(f"bs {bs}: e2e {e2e:.3f} ms ({bs * 1000 / e2e:.1f} img/s), "
              f"forward {fwd:.3f} ms, tail {tail:.3f} ms [{card}]",
              flush=True)

    bs = max(BATCHES)
    x = torch.randint(0, 256, (bs, 640, 640, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    for _ in range(3):
        predictor.predict_batch(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(TRACED_CALLS):
            predictor.predict_batch(x)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / TRACED_CALLS
    kernels = [k for k in prof.key_averages()
               if k.device_type == torch.autograd.DeviceType.CUDA]
    # ms a batch and launches a batch, by kernel and by group
    rows = [(k.self_device_time_total / 1000.0 / TRACED_CALLS,
             k.count // TRACED_CALLS, k.key) for k in kernels]
    busy = sum(r[0] for r in rows)
    print(f"bs {bs} traced: {window:.3f} ms a batch, device busy "
          f"{busy:.3f} ms = {100 * busy / window:.1f}% [{card}]")
    groups = defaultdict(lambda: [0.0, 0])
    for ms, n, key in rows:
        groups[group_of(key)][0] += ms
        groups[group_of(key)][1] += n
    print("device time by group (ms a batch, share of busy, launches):")
    for name, (ms, n) in sorted(groups.items(), key=lambda g: -g[1][0]):
        print(f"  {ms:9.3f}  {100 * ms / busy:5.1f}%  {n:5d}  {name}")
    print("top kernels (ms a batch, launches, name):")
    for ms, n, key in sorted(rows, key=lambda r: -r[0])[:25]:
        print(f"  {ms:9.3f}  {n:5d}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
