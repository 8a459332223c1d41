"""Process groups and the helpers around them (the counterpart of
``yolov7_d2_tpu/parallel/mesh.py`` with detectron2's ``comm``).

The JAX package runs one jitted step over a mesh of every device, and the
batch is split by the compiler. The port runs one process per device, each
on its share of the batch, in a ``torch.distributed`` group: NCCL for CUDA
devices, gloo for the CPU. Without a group every helper answers as the one
process of a world of 1.

Inside a group the processes form a (data, model) grid
(``parallel/mesh.py``): the batch is split over the data axis, so every
reduction over the batch goes over the data group and counts data ranks
(:func:`get_data_size`, :func:`data_group`); the model axis shards the
widest parameters. Until ``mesh.build_grid`` sets a grid, the grid is
(world, 1): the data group is the world.
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

# the process's ``mesh.Grid`` (set by ``mesh.build_grid``), None: (world, 1)
_GRID = None


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


def set_grid(grid) -> None:
    """Make ``grid`` (a ``mesh.Grid``, or None) the current grid."""
    global _GRID
    _GRID = grid


def current_grid():
    """The grid that ``mesh.build_grid`` set inside the current group, else
    None."""
    return _GRID if is_initialized() else None


def get_data_size() -> int:
    """The ranks of the data axis: the processes that split the batch."""
    grid = current_grid()
    return grid.data_size if grid is not None else get_world_size()


def get_data_rank() -> int:
    """This process's place on the data axis: the share of the batch it
    takes, and the seed of its draws."""
    grid = current_grid()
    return grid.data_rank if grid is not None else get_rank()


def data_group():
    """The group of the data axis that holds this process (the world
    without a grid)."""
    grid = current_grid()
    return grid.data_group if grid is not None else dist.group.WORLD


def get_model_size() -> int:
    grid = current_grid()
    return grid.model_size if grid is not None else 1


def get_model_rank() -> int:
    grid = current_grid()
    return grid.model_rank if grid is not None else 0


def model_group():
    """The group of the model axis that holds this process (None on an
    axis of 1)."""
    grid = current_grid()
    return grid.model_group if grid is not None else None


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
    ``local_process_batch_slice``); the batch must divide by the data
    axis's size (the model ranks of a data slice take the same share)."""
    data = get_data_size()
    if global_batch % data:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"into {data} data ranks")
    return global_batch // data


def _collective_device() -> torch.device:
    if dist.get_backend() == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the data ranks (a new tensor, without
    gradient): a loss's global count; ``tensor`` itself without a group or
    on a data axis of 1."""
    if get_data_size() == 1:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out, group=data_group())
    return out


def all_reduce_scalars(
        scalars: Dict[str, Union[torch.Tensor, float, int]],
        op: dist.ReduceOp = dist.ReduceOp.SUM) -> Dict[str, float]:
    """``{name: sum (or ``op``) over the data ranks}`` as floats, for
    logged metrics: one all_reduce of every value, in float64, and one
    fetch."""
    if not scalars:
        return {}
    keys = sorted(scalars)  # every rank reduces in the same order
    if get_data_size() == 1:
        return {k: float(scalars[k]) for k in keys}
    device = _collective_device()
    values = torch.stack([torch.as_tensor(scalars[k]).to(device,
                                                         torch.float64)
                          for k in keys])
    dist.all_reduce(values, op=op, group=data_group())
    return dict(zip(keys, values.tolist()))
