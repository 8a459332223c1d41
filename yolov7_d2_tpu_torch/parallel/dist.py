"""Process groups and the helpers around them (the counterpart of
``yolov7_d2_tpu/parallel/mesh.py`` with detectron2's ``comm``).

The JAX package runs one jitted step over a mesh of every device, and the
batch is split by the compiler. The port runs one process per device, each
on its share of the batch, in a ``torch.distributed`` group: NCCL for CUDA
devices, gloo for the CPU. Without a group every helper answers as the one
process of a world of 1.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Union

import torch
import torch.distributed as dist

# detectron2's timeout: rank 0's COCO eval on the full val set outlasts the
# default collective timeout while the other ranks wait at a barrier
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(backend: str, dist_url: str, world_size: int,
                     rank: int,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the group of ``world_size`` processes at ``dist_url``
    (``tcp://host:port`` of rank 0's machine) as ``rank``."""
    dist.init_process_group(backend=backend, init_method=dist_url,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    """The rank among this machine's processes, which is the index of its
    device (``LOCAL_RANK``, set by ``parallel.launch`` as by torchrun)."""
    return int(os.environ.get("LOCAL_RANK", 0)) if is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier of all ranks; nothing without a group."""
    if not is_initialized():
        return
    if dist.get_backend() == dist.Backend.NCCL:
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def local_batch_size(global_batch: int) -> int:
    """This process's share of a global batch (the counterpart of
    ``local_process_batch_slice``); the batch must divide by the world
    size."""
    world = get_world_size()
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"into {world} processes")
    return global_batch // world


def _collective_device() -> torch.device:
    if dist.get_backend() == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks (a new tensor, without
    gradient); ``tensor`` itself without a group."""
    if not is_initialized():
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_scalars(
        scalars: Dict[str, Union[torch.Tensor, float, int]],
        op: dist.ReduceOp = dist.ReduceOp.SUM) -> Dict[str, float]:
    """``{name: sum (or ``op``) over ranks}`` as floats, for logged
    metrics: one all_reduce of every value, in float64, and one fetch."""
    if not scalars:
        return {}
    keys = sorted(scalars)  # every rank reduces in the same order
    if not is_initialized():
        return {k: float(scalars[k]) for k in keys}
    device = _collective_device()
    values = torch.stack([torch.as_tensor(scalars[k]).to(device,
                                                         torch.float64)
                          for k in keys])
    dist.all_reduce(values, op=op)
    return dict(zip(keys, values.tolist()))
