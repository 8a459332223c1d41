"""detectron2's ``launch`` for the port: one process per device.

    launch(main_fn, num_gpus, num_machines, machine_rank, dist_url, args)

runs ``main_fn(*args)`` on ``num_gpus`` processes of this machine, ranks
``machine_rank * num_gpus`` onwards of ``num_gpus * num_machines``, each in
the group at ``dist_url``. A world of 1 calls ``main_fn`` here, with no
group. ``main_fn`` and ``args`` go to the children by pickle (``spawn``),
so ``main_fn`` is a function that can be imported by its module's name.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from yolov7_d2_tpu_torch.parallel.dist import (
    DEFAULT_TIMEOUT,
    init_distributed,
    set_grid,
)


def local_dist_url() -> str:
    """``tcp://127.0.0.1:<port>`` on a port that was free a moment ago
    (bound to port 0, so that concurrent launches do not collide)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _distributed_worker(local_rank: int, main_fn: Callable, world_size: int,
                        num_gpus: int, machine_rank: int, backend: str,
                        dist_url: str, args: Sequence,
                        timeout: datetime.timedelta) -> None:
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    if "OMP_NUM_THREADS" not in os.environ:
        # torchrun's default: a machine's ranks would otherwise each start
        # a thread per core and contend for them
        torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(local_rank)
    init_distributed(backend, dist_url, world_size,
                     machine_rank * num_gpus + local_rank, timeout)
    try:
        main_fn(*args)
    finally:
        set_grid(None)
        dist.destroy_process_group()


def launch(main_fn: Callable, num_gpus: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto",
           args: Sequence = (), backend: Optional[str] = None,
           timeout: Optional[float] = None):
    """Run ``main_fn(*args)`` on every process of this machine and return
    its result in a world of 1 (None otherwise).

    ``backend`` is NCCL by default: process i takes card i, and fewer
    visible cards than ``num_gpus`` raise (no card is shared, nothing falls
    back to the CPU). ``"gloo"`` leaves the device to ``main_fn``: the CPU,
    or several ranks on one card. ``dist_url`` ``"auto"`` takes a free local
    port (one machine only). ``timeout``: seconds of wall clock after which
    every child is killed and ``TimeoutError`` raised (none by default)."""
    world_size = num_gpus * num_machines
    if world_size == 1:
        return main_fn(*args)
    backend = backend or "nccl"
    if backend == "nccl" and torch.cuda.device_count() < num_gpus:
        raise RuntimeError(
            f"--num-gpus {num_gpus} but {torch.cuda.device_count()} CUDA "
            "card(s) are visible; set MODEL.DEVICE cpu to train on the CPU")
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("dist_url 'auto' works on one machine only; "
                             "give tcp://<machine 0>:<port>")
        dist_url = local_dist_url()
    ctx = mp.start_processes(
        _distributed_worker, nprocs=num_gpus, start_method="spawn",
        join=False, args=(main_fn, world_size, num_gpus, machine_rank,
                          backend, dist_url, tuple(args), DEFAULT_TIMEOUT))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        # join raises where a child failed, after terminating the others
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{num_gpus} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return None
