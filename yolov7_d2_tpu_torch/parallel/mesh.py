"""The (data, model) process grid and tensor parallelism over its model axis
(the counterpart of ``yolov7_d2_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` with axes ``(data,
model)``: the batch is sharded over ``data``, and with ``tp_min_features``
the widest kernels over ``model`` (``state_shardings``), and GSPMD inserts
the collectives. The port runs one process a device, so the mesh is a grid
of ranks, rank ``r`` at data ``r // model`` and model ``r % model`` (JAX's
``np.asarray(devices).reshape(shape)``), with a process group along each
axis (:func:`build_grid`). The batch is split over the data axis
(``parallel.dist``: every reduction over the batch goes over the data
group), and :func:`shard_model` writes the collectives GSPMD would insert:

* :func:`tp_param_names` is the JAX rule: a parameter whose flax leaf has
  two or more dimensions is sharded over ``model`` where the leaf's last
  axis (flax's output features) is at least ``tp_min_features`` and
  divides by the axis size. The torch axis that carries flax's last one is
  the weight carrier's (``deploy.quantize.leaf_layouts``): dim 0 of a
  ``Conv2d`` or ``Linear`` weight, dim 1 of a ``ConvTranspose2d`` weight,
  the last of a table; an attention's packed ``in_proj_weight`` /
  ``in_proj_bias`` carry flax's query, key and value leaves, whose last
  axis is the head dimension, so they shard by the rows of each head.
* A selected ``Conv2d`` or ``Linear`` runs column-parallel
  (:class:`ColumnParallelConv2d`, :class:`ColumnParallelLinear`): it holds
  its rank's rows of the weight, its input passes through an identity
  whose backward sums the gradient over the model group, it computes its
  rank's output channels, and the channels are gathered (the backward takes
  the rank's slice back: every model rank runs the layers after the gather
  on the same values and so gets the same gradient); the whole bias, 1-D
  and replicated as in JAX, is added after. A grouped convolution shards
  whole groups and takes the input channels of its groups.
* Any other selected parameter is held sharded and gathered whole where it
  is read (``module.weight`` of a sharded module is the gathered tensor,
  its gradient sliced back): ``ConvTranspose2d``, embeddings, attention's
  packed projections, raw parameters, and a convolution whose forward
  reads its weight itself (the deformable convolution's fuse).

Replicated parameters (biases, norms, the narrow layers) compute the same
gradient on every model rank, up to the sum order of the library's
backward kernels (ROADMAP.md C.14), so the train step takes model rank 0's
(:func:`replicate_grads_over_model`) and they stay bitwise equal. The
gradient norm sums a sharded parameter's squares over the model group
and counts a replicated one once, as optax's ``global_norm`` reads sharded
arrays (:func:`grid_global_norm`).

Collectives: ``all_reduce`` and ``all_gather`` only (gloo has no
``reduce_scatter``); where gloo holds CUDA tensors a gather is the
``all_reduce`` of a zero-filled buffer in which each rank writes its part
(x + 0 = x: the same bits), as ``SyncBatchNorm2d`` does. Nothing falls back
to a replicated run: a collective that fails raises.

Order matters: :func:`shard_model` replaces ``Parameter`` objects, so it
runs before the optimizer, the EMA copy and the DDP wrapper are built
(``engine._train_state``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.parallel import dist as pdist

# None: a gather over gloo of CUDA tensors is the all_reduce of a zero-filled
# buffer, every other gather an all_gather; True / False force one of them
# (the CPU tests take both)
GATHER_BY_ALL_REDUCE: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class Grid:
    """A process's place in the grid: ``shape`` (data, model) in
    ``axis_names``' order, its coordinates and the groups along its two
    axes (None where the axis has one rank, the world group where it holds
    every rank)."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_size(self) -> int:
        return self.shape[self.axis_names.index("data")]

    @property
    def model_size(self) -> int:
        return self.shape[self.axis_names.index("model")]

    @classmethod
    def layout(cls, mesh_shape: Sequence[int], world: int, rank: int,
               axis_names: Sequence[str] = ("data", "model")) -> "Grid":
        """The grid of ``world`` ranks that ``mesh_shape`` describes (``-1``
        inferred from ``world``), seen from ``rank``, without groups:
        ``build_mesh``'s checks and messages."""
        names = tuple(axis_names)
        if sorted(names) != ["data", "model"] or len(mesh_shape) != 2:
            raise ValueError(f"build_grid: axes {names} of shape "
                             f"{tuple(mesh_shape)}: the grid has the two "
                             "axes 'data' and 'model'")
        shape = [int(s) for s in mesh_shape]
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            if known <= 0 or world % known or world < known:
                raise ValueError(
                    f"build_grid: cannot infer -1 in mesh_shape "
                    f"{tuple(mesh_shape)} from {world} process(es); need a "
                    f"positive multiple of {known} (--num-gpus x "
                    "--num-machines)")
            shape[shape.index(-1)] = world // known
        if int(np.prod(shape)) != world:
            raise ValueError(
                f"build_grid: mesh shape {tuple(shape)} needs "
                f"{int(np.prod(shape))} processes but the world has {world} "
                "(--num-gpus x --num-machines)")
        coords = np.unravel_index(rank, shape)
        at = dict(zip(names, (int(c) for c in coords)))
        return cls(tuple(shape), names, at["data"], at["model"])


def _axis_groups(shape: Tuple[int, int], axis: int, world: int,
                 rank: int):
    """The group along ``axis`` that holds ``rank``: every rank creates
    every group of the axis, in the same order (``dist.new_group`` is a
    collective of the whole world), where the axis has more than one and
    fewer than ``world`` ranks."""
    ranks = np.arange(world).reshape(shape)
    size = shape[axis]
    if size == 1:
        return None
    if size == world:
        return dist.group.WORLD
    mine = None
    lines = np.moveaxis(ranks, axis, -1).reshape(-1, size)
    for line in lines:
        group = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = group
    return mine


def build_grid(mesh_shape: Sequence[int] = (-1, 1),
               axis_names: Sequence[str] = ("data", "model")) -> Grid:
    """The counterpart of ``build_mesh``: this process's :class:`Grid` in
    the world of the process group, with a group along each axis, made the
    current grid of ``parallel.dist``'s helpers until the group ends
    (without a group: the grid of a world of 1, and no current grid).
    Every rank of the world calls it, with the same shape. A world that the
    shape does not fit raises ``ValueError``."""
    world, rank = pdist.get_world_size(), pdist.get_rank()
    grid = Grid.layout(mesh_shape, world, rank, axis_names)
    if not pdist.is_initialized():
        pdist.set_grid(None)
        return grid
    data_axis = grid.axis_names.index("data")
    grid = dataclasses.replace(
        grid, data_group=_axis_groups(grid.shape, data_axis, world, rank),
        model_group=_axis_groups(grid.shape, 1 - data_axis, world, rank))
    pdist.set_grid(grid)
    return grid


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a parameter is sharded over the model axis: along ``dim`` of
    the tensor, or of its view ``view`` (an attention's packed projection
    [3E, E] viewed as [3, H, D, E]: the head dimension D, flax's last axis
    of the query, key and value leaves). A rank's shard is the
    ``model_rank``-th of ``model_size`` equal slices, flattened back to the
    tensor's trailing shape."""

    dim: int
    view: Optional[Tuple[int, ...]] = None

    def take(self, full: torch.Tensor, size: int, rank: int) -> torch.Tensor:
        v = full.reshape(self.view) if self.view else full
        n = v.shape[self.dim] // size
        part = v.narrow(self.dim, rank * n, n)
        if self.view:
            part = part.reshape((-1,) + tuple(full.shape[1:]))
        return part.contiguous()

    def shard_view(self, shard: torch.Tensor, size: int) -> torch.Tensor:
        if not self.view:
            return shard
        shape = list(self.view)
        shape[self.dim] //= size
        return shard.reshape(shape)

    def full_shape(self, shard_shape: Sequence[int],
                   size: int) -> Tuple[int, ...]:
        if self.view:
            return (shard_shape[0] * size,) + tuple(shard_shape[1:])
        shape = list(shard_shape)
        shape[self.dim] *= size
        return tuple(shape)


def tp_param_names(model: nn.Module, model_size: int,
                   tp_min_features: int) -> Dict[str, ShardSpec]:
    """``{parameter name: ShardSpec}`` of the parameters the JAX
    ``state_shardings`` shards over a model axis of ``model_size``: a flax
    leaf of two or more dimensions whose last axis is at least
    ``tp_min_features`` and divides by ``model_size``. Empty for a model
    axis of 1 or a threshold of 0 (every leaf replicated)."""
    from yolov7_d2_tpu_torch.deploy.quantize import leaf_layouts

    if model_size <= 1 or tp_min_features <= 0:
        return {}
    params = dict(model.named_parameters(remove_duplicate=False))
    out: Dict[str, ShardSpec] = {}
    for name, layout in leaf_layouts(model).items():
        p = params[name]
        if layout.heads:
            # flax's query, key and value kernels [E, H, D] and biases
            # [H, D]: the last axis is D, the rows h D + d of each block
            h = layout.heads
            d = p.shape[0] // 3 // h
            features = d
            spec = ShardSpec(2, (3, h, d) + tuple(p.shape[1:]))
        else:
            features = p.shape[layout.dim]
            spec = ShardSpec(layout.dim)
        if features >= tp_min_features and features % model_size == 0:
            out[name] = spec
    return out


# ---------------------------------------------------------------------------
# collectives, each an autograd Function
# ---------------------------------------------------------------------------

def _gather_by_all_reduce(t: torch.Tensor, group) -> bool:
    if GATHER_BY_ALL_REDUCE is not None:
        return GATHER_BY_ALL_REDUCE
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _all_gather_along(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``t`` concatenated along ``dim`` in rank order,
    in ``t``'s memory format; the collectives see contiguous tensors."""
    size, rank = pdist.get_model_size(), pdist.get_model_rank()
    group = pdist.model_group()
    src = t.contiguous()
    if _gather_by_all_reduce(src, group):
        shape = list(src.shape)
        n = shape[dim]
        shape[dim] = n * size
        out = src.new_zeros(shape)
        out.narrow(dim, rank * n, n).copy_(src)
        dist.all_reduce(out, group=group)
    else:
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim)
    if _channels_last(t):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def _all_reduce_model(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the model group, as a new tensor in ``t``'s
    memory format."""
    out = t.contiguous()
    out = out.clone() if out is t else out
    dist.all_reduce(out, group=pdist.model_group())
    if _channels_last(t):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group (each
    model rank's gradient is the part of its own output channels)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_model(grad)


class _GatherAlong(torch.autograd.Function):
    """The model ranks' slices concatenated along ``dim``; the backward
    takes this rank's slice of the gradient and sums nothing."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.rank = pdist.get_model_rank()
        return _all_gather_along(t, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n)
        return part.clone(memory_format=torch.preserve_format), None


def gather_param(shard: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
    """The whole parameter from the model ranks' shards (differentiable:
    the gradient of the whole is sliced back to this rank's shard)."""
    size = pdist.get_model_size()
    full = _GatherAlong.apply(spec.shard_view(shard, size), spec.dim)
    return full.reshape(spec.full_shape(shard.shape, size))


# ---------------------------------------------------------------------------
# the sharded modules
# ---------------------------------------------------------------------------

class ShardedModule(nn.Module):
    """The base of a module whose parameters ``_tp_specs`` ({own name:
    ShardSpec}) are held sharded over the model axis: reading one as an
    attribute (``module.weight``) gives the whole tensor, gathered from
    the model ranks (a collective every model rank runs alike). The
    parameter itself, in ``named_parameters()`` and ``state_dict()``, is
    the shard."""

    def __getattr__(self, name: str):
        specs = self.__dict__.get("_tp_specs")
        if specs and name in specs:
            return gather_param(self._parameters[name], specs[name])
        return super().__getattr__(name)


class ColumnParallelConv2d(ShardedModule, nn.Conv2d):
    """An ``nn.Conv2d`` that holds its model rank's rows [O / tp, C / g,
    kh, kw] of the weight and computes those output channels (a grouped
    one, groups % tp == 0, takes the input channels of its groups); the
    channels are gathered, then the whole bias is added."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size, rank = pdist.get_model_size(), pdist.get_model_rank()
        x = _CopyToModel.apply(x)
        groups = self.groups
        cdim = x.dim() - 3
        if groups > 1:
            c = x.shape[cdim] // size
            x = x.narrow(cdim, rank * c, c)
            groups //= size
        padding = self.padding
        if self.padding_mode != "zeros":
            x = F.pad(x, self._reversed_padding_repeated_twice,
                      mode=self.padding_mode)
            padding = 0
        y = F.conv2d(x, self._parameters["weight"], None, self.stride,
                     padding, self.dilation, groups)
        y = _GatherAlong.apply(y, cdim)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(-1, 1, 1)
        return y


class ColumnParallelLinear(ShardedModule, nn.Linear):
    """An ``nn.Linear`` that holds its model rank's rows [O / tp, I] of the
    weight and computes those output features; the features are gathered,
    then the whole bias is added."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_CopyToModel.apply(x), self._parameters["weight"])
        y = _GatherAlong.apply(y, y.dim() - 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


_SHARDED_CLASSES: Dict[type, type] = {nn.Conv2d: ColumnParallelConv2d,
                                      nn.Linear: ColumnParallelLinear}


def sharded_class(cls: type) -> type:
    """The class a module of ``cls`` takes when a parameter of it is
    sharded: the column-parallel ones for ``nn.Conv2d`` and ``nn.Linear``,
    for their subclasses a subclass of both (whose ``super().forward``
    runs column-parallel; a forward that reads ``self.weight`` itself gets
    it gathered whole), for any other module a subclass of it and
    :class:`ShardedModule`."""
    if cls not in _SHARDED_CLASSES:
        base = (ColumnParallelConv2d if issubclass(cls, nn.Conv2d)
                else ColumnParallelLinear if issubclass(cls, nn.Linear)
                else ShardedModule)
        _SHARDED_CLASSES[cls] = type(f"Sharded{cls.__name__}", (cls, base),
                                     {"__module__": cls.__module__})
    return _SHARDED_CLASSES[cls]


def is_sharded(p: torch.Tensor) -> bool:
    """Whether ``p`` is a parameter :func:`shard_model` sharded."""
    return getattr(p, "tp_sharded", False)


def shard_model(model: nn.Module,
                tp_min_features: int) -> Dict[str, ShardSpec]:
    """Shard ``model`` in place over the model axis of the current grid by
    :func:`tp_param_names`: each parameter the
    rule selects becomes its rank's shard (a new ``Parameter``, so build
    the optimizer, the EMA and DDP after this), and its module takes
    :func:`sharded_class`, keeping its name, type and parameter names.
    Returns the rule's ``{name: ShardSpec}``. A selected parameter shared
    by two modules, or a grouped convolution whose groups do not divide by
    the model axis, raises ``NotImplementedError``."""
    size, rank = pdist.get_model_size(), pdist.get_model_rank()
    specs = tp_param_names(model, size, tp_min_features)
    if not specs:
        return specs
    owners: Dict[int, str] = {}
    by_module: Dict[str, Tuple[nn.Module, Dict[str, ShardSpec]]] = {}
    for mname, module in model.named_modules(remove_duplicate=False):
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if id(p) in owners and (name in specs or owners[id(p)] in specs):
                raise NotImplementedError(
                    f"{name} and {owners[id(p)]} share one parameter, which "
                    "the model axis would shard: tied weights are not "
                    "sharded (ROADMAP.md A.6b)")
            owners[id(p)] = name
            if name in specs:
                by_module.setdefault(mname, (module, {}))[1][pname] = \
                    specs[name]
    for mname, (module, own) in by_module.items():
        if (isinstance(module, nn.Conv2d) and module.groups > 1
                and module.groups % size):
            raise NotImplementedError(
                f"{mname}: a convolution of {module.groups} groups on a "
                f"model axis of {size}: column parallelism shards whole "
                "groups (ROADMAP.md A.6b)")
        module.__class__ = sharded_class(type(module))
        module._tp_specs = own
        for pname, spec in own.items():
            p = module._parameters[pname]
            shard = nn.Parameter(spec.take(p.detach(), size, rank).clone(),
                                 requires_grad=p.requires_grad)
            shard.tp_sharded = True
            module._parameters[pname] = shard
    return specs


def sharded_specs(model: nn.Module) -> Dict[str, ShardSpec]:
    """``{parameter name: ShardSpec}`` of the parameters of ``model`` that
    :func:`shard_model` sharded."""
    out = {}
    for mname, module in model.named_modules():
        for pname, spec in module.__dict__.get("_tp_specs", {}).items():
            out[f"{mname}.{pname}" if mname else pname] = spec
    return out


# ---------------------------------------------------------------------------
# the train step's reductions and the weight carrier
# ---------------------------------------------------------------------------

def replicate_grads_over_model(params: Iterable[torch.Tensor]) -> None:
    """Make the gradients of the replicated parameters among ``params``
    model rank 0's, bitwise, on every model rank (one all_reduce of a
    buffer the other model ranks fill with zeros). Nothing on a model axis
    of 1."""
    if pdist.get_model_size() == 1:
        return
    grads = [p.grad for p in params
             if p.grad is not None and not is_sharded(p)]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if pdist.get_model_rank() != 0:
        flat.zero_()
    dist.all_reduce(flat, group=pdist.model_group())
    with torch.no_grad():
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def grid_global_norm(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm of the whole parameters' gradients: the sharded
    ones' squares summed over the model group, the replicated ones counted
    once (optax ``global_norm`` on sharded arrays)."""
    sharded = [p.grad for p in params if is_sharded(p)]
    replicated = [p.grad for p in params if not is_sharded(p)]
    sq = torch.zeros((), dtype=torch.float32,
                     device=(sharded or replicated)[0].device)
    if sharded:
        sq = torch.stack(torch._foreach_norm(sharded)).float().square().sum()
        dist.all_reduce(sq, group=pdist.model_group())
    if replicated:
        sq = sq + torch.stack(
            torch._foreach_norm(replicated)).float().square().sum()
    return sq.sqrt()


@torch.no_grad()
def gather_tensors(tensors: Mapping[str, torch.Tensor],
                   specs: Mapping[str, ShardSpec]) -> Dict[str, torch.Tensor]:
    """``tensors`` by name with every one named in ``specs`` gathered whole
    from the model ranks (a collective: every model rank calls it)."""
    return {k: gather_param(v, specs[k]) if k in specs else v
            for k, v in tensors.items()}


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a sharded ``model``, on every rank (a
    collective of the model group), with the keys and shapes of the
    unsharded model: what a checkpoint or one process loads."""
    return gather_tensors(model.state_dict(), sharded_specs(model))


def shard_state_dict(full: Mapping[str, torch.Tensor],
                     specs: Mapping[str, ShardSpec]
                     ) -> Dict[str, torch.Tensor]:
    """This model rank's shard of a whole state dict (``specs`` from
    :func:`shard_model` or :func:`sharded_specs`): what
    ``jax.device_put(state, state_shardings(...))`` puts on a device of
    the ``model`` axis."""
    size, rank = pdist.get_model_size(), pdist.get_model_rank()
    return {k: specs[k].take(v, size, rank) if k in specs else v
            for k, v in full.items()}
