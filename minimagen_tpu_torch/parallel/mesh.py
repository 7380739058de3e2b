"""Meshes, sharding plans and the collectives of data parallelism, ZeRO-1,
FSDP and tensor parallelism (counterpart of ``minimagen_tpu/parallel/mesh.py``).

A :class:`Mesh` is a process group seen as the JAX mesh's (``data``,
``model``) axes: ``make_mesh(model_parallel=k)`` lays the processes out as
a grid of ``world // k`` rows of ``k``, as the JAX package reshapes its
devices (``mesh.py:47``), so a model group is k consecutive ranks and a data
group the ranks with one model index. ``mesh.group`` is this process's data
group (``size`` and ``rank`` are the data axis's), ``mesh.model_group`` its
model group. Each process holds its rows of the batch by data index
(:func:`shard_batch`): the processes of one model group hold the same rows.

Tensor parallelism (:func:`tp_rule`, the JAX package's
``infer_param_shardings``, ``mesh.py:109-130``, copied): the weight of a
``Dense``, ``Conv`` or ``Conv2d`` module (a JAX ``kernel`` leaf) is split
over ``model`` on its output axis (the JAX layout's trailing axis, the
port's axis 0) when that axis divides by the model size and is at least
`min_shard_dim` wide; biases, norms and narrow kernels stay replicated.
``parallel/tensor.py`` places the blocks (a parameter then holds its model
block, with a :class:`ModelShard` on it) and computes the column-parallel
forward.

A :class:`Plan` says, for each parameter of the port's list (U-Net by U-Net,
in module order), which axis of its model block is split over the ``data``
axis, by the JAX package's rule (:func:`zero1_rule`, ``mesh.py:141-159``
copied): the largest axis divisible by the data size, in the JAX parameter's
layout (HWIO convolutions, (in, out) dense kernels), mapped back onto the
port's axis; scalars, leaves under `min_size` elements and leaves with no
divisible axis are replicated, and at data size 1 everything is; and which
axis is split over ``model``. :func:`zero1_plan` shards the gradients,
Adam's moments, the accumulators and the EMA by it (on a model axis, within
each process's model block, as ``zero1_shardings(params_shardings=)``
composes with tensor parallelism: the update is elementwise, so the numbers
are the same); :func:`fsdp_plan` the parameters too, on a data-only mesh.

The training step (``training.make_train_step(mesh=)``) uses:

- :func:`reduce_gradients`: each gradient summed over the data group, then
  divided by its size, in float32; a sharded leaf comes back as this rank's
  shard (a reduce-scatter), a replicated one whole (an all-reduce). The
  processes of a model group compute the same gradients for their
  replicated leaves (everything after a column-parallel layer is computed
  whole on each), so nothing is reduced over ``model``;
- :func:`global_norm_fn`: the norm of clip-50 over every element once
  (a leaf's squares summed over the groups that split it);
- :func:`sync_params`: under ZeRO-1 the updated shards all-gathered into the
  replicated parameters (or model blocks);
- :func:`gathered`: under FSDP a parameter lives as its shard
  (:class:`ParamShard`, on the parameter) and its ``data`` is empty; inside
  the context it is all-gathered into a plain contiguous tensor (the kernels
  take nothing else) and emptied again at exit. Training, evaluation and
  sampling gather one stage's U-Net at a time.

:func:`broadcast_params` gives every process process 0's parameters when a
train state is made on a mesh, as DDP does at construction.

Collectives are packed into flat float32 buffers of at most
:data:`BUCKET_ELEMENTS` elements. A sharded leaf packs as its axis moved to
the front, so rank r's chunk of a bucket is the r-th slab of every leaf.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import collectives
from .collectives import Group

MIN_SIZE = 4096  # the JAX rule's default: smaller leaves stay replicated
MIN_SHARD_DIM = 128  # infer_param_shardings' default: narrower kernels stay whole
BUCKET_ELEMENTS = 1 << 25  # 128 MiB of float32 per collective
SHARD_ATTR = "_mesh_shard"  # where an FSDP parameter keeps its shard
MODEL_ATTR = "_model_shard"  # where a tensor-parallel parameter keeps its placement


@dataclass(frozen=True)
class Mesh:
    """The (``data``, ``model``) axes over a process group: `group` is this
    process's data group, `model_group` its model group (None: the model
    axis has size 1), `world_group` every process of the mesh (default
    `group`)."""

    group: Group
    model_group: Optional[Group] = None
    world_group: Optional[Group] = None

    @property
    def size(self) -> int:
        """The data axis's size."""
        return self.group.size

    @property
    def rank(self) -> int:
        """This process's data index (-1 outside the mesh)."""
        return self.group.rank

    @property
    def data_rank(self) -> int:
        return self.group.rank

    @property
    def model_size(self) -> int:
        return 1 if self.model_group is None else self.model_group.size

    @property
    def model_rank(self) -> int:
        return 0 if self.model_group is None else self.model_group.rank

    @property
    def world(self) -> Group:
        return self.group if self.world_group is None else self.world_group

    @property
    def is_leader(self) -> bool:
        """Whether this is the mesh's first process (data and model index 0),
        the one that writes files."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size, "model": self.model_size}

    def rows(self, n: int, *, even: bool = True) -> slice:
        """This process's rows of `n` by its data index: equal blocks (`n`
        must divide by the data size, as the JAX package asserts), or with
        `even` False blocks that differ by at most one row, the larger
        first."""
        if even and n % self.size:
            raise ValueError(f"a batch of {n} rows does not divide the data axis of {self.size}")
        per, extra = divmod(n, self.size)
        lo = self.rank * per + min(self.rank, extra)
        return slice(lo, lo + per + (self.rank < extra))


def make_mesh(group: Optional[Group] = None, *, model_parallel: int = 1, device=None) -> Mesh:
    """A ('data', 'model') mesh over `group` (default: the world, joined from
    torchrun's or the JAX package's environment by
    :func:`.multihost.initialize_distributed`, else a world of one process on
    `device`), with a model axis of `model_parallel` consecutive processes
    (the group's size must divide by it, as the JAX package asserts). Every
    process of the world calls it, in the same order: a model axis makes
    process groups."""
    if group is None:
        if not torch.distributed.is_initialized():
            from .multihost import initialize_distributed  # noqa: PLC0415

            if not initialize_distributed(device):
                if not torch.distributed.is_initialized():
                    collectives.init_process(0, 1, device=device,
                                             store=torch.distributed.HashStore())
        group = collectives.world()
    if group.size % model_parallel:
        raise ValueError(f"{group.size} processes do not divide by model_parallel="
                         f"{model_parallel}")
    if model_parallel == 1:
        return Mesh(group)
    data, model = collectives.mesh_groups(group, model_parallel)
    return Mesh(data, model, group)


def shard_batch(batch, mesh: Mesh, *, even: bool = True):
    """This rank's rows of every array of a host batch (None passes)."""
    if not batch:
        return batch
    n = len(next(iter(batch.values())))
    rows = mesh.rows(n, even=even)
    return {k: v[rows] for k, v in batch.items()}


def cast_params(params: Iterable[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """Floating-point tensors cast to `dtype` (others as they are)."""
    return [p.to(dtype) if p.is_floating_point() else p for p in params]


# --------------------------------------------------------------------------- #
# the sharding rule and plans                                                  #
# --------------------------------------------------------------------------- #
def zero1_rule(shape: Sequence[int], data_size: int, min_size: int = MIN_SIZE) -> Optional[int]:
    """The JAX package's ``_zero1_rule``: the axis of `shape` to shard over a
    data axis of `data_size`, or None to replicate."""
    shape = tuple(int(s) for s in shape)
    if data_size == 1 or len(shape) == 0 or int(np.prod(shape)) < min_size:
        return None
    cands = [i for i in range(len(shape)) if shape[i] % data_size == 0]
    if not cands:
        return None
    return max(cands, key=lambda i: shape[i])


def jax_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """For each axis of the JAX parameter, the port's axis holding it
    (``checkpoint.flax_unet_tree``'s layout: OIHW -> HWIO, (out, in) -> (in,
    out))."""
    if name.endswith("weight") and ndim == 4:
        return (2, 3, 1, 0)
    if name.endswith("weight") and ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


def leaf_axis(name: str, shape: Sequence[int], data_size: int,
              min_size: int = MIN_SIZE) -> Optional[int]:
    """The port's axis of parameter `name` that the rule shards, or None."""
    perm = jax_axes(name, len(shape))
    axis = zero1_rule([shape[a] for a in perm], data_size, min_size)
    return None if axis is None else perm[axis]


def tp_rule(name: str, shape: Sequence[int], model_size: int,
            min_shard_dim: int = MIN_SHARD_DIM, kernel: bool = True) -> Optional[int]:
    """The JAX package's ``infer_param_shardings`` rule for one leaf: the
    port's axis of parameter `name` (of full `shape`) split over a model
    axis of `model_size`, or None. Only a kernel (`kernel`: the weight of a
    ``Dense``, ``Conv`` or ``Conv2d``) of two axes or more is split, on its
    output axis (the JAX layout's trailing one), where that divides by the
    model size and is at least `min_shard_dim` wide."""
    if model_size == 1 or not kernel or len(shape) < 2:
        return None
    axis = jax_axes(name, len(shape))[-1]
    out = int(shape[axis])
    return axis if out % model_size == 0 and out >= min_shard_dim else None


@dataclass
class ModelShard:
    """A tensor-parallel parameter's placement: its full shape, the axis
    split over the model axis, and the mesh; the parameter's data is this
    process's block."""

    shape: torch.Size
    axis: int
    mesh: "Mesh"


def block_shape(shape: Sequence[int], axis: Optional[int], parts: int) -> torch.Size:
    """`shape` with `axis` (None: none) divided into `parts`."""
    shape = list(shape)
    if axis is not None:
        shape[axis] //= parts
    return torch.Size(shape)


def kernel_names(module: torch.nn.Module) -> set:
    """The names of `module`'s parameters that are JAX ``kernel`` leaves:
    the weights of its ``Dense``, ``Conv`` and ``Conv2d`` modules."""
    from ..models.layers import Conv2d, Dense  # noqa: PLC0415 (models import nothing of parallel)

    return {f"{n}.weight" if n else "weight" for n, m in module.named_modules()
            if isinstance(m, (Dense, Conv2d))}


def model_axes(modules, model_size: int, min_shard_dim: int = MIN_SHARD_DIM
               ) -> Tuple[Optional[int], ...]:
    """For each parameter of `modules` (in order), the axis split over a
    model axis of `model_size`: a parameter already placed keeps its
    placement, the others take :func:`tp_rule`."""
    out = []
    for m in modules:
        kernels = kernel_names(m)
        for name, p in m.named_parameters():
            placed = getattr(p, MODEL_ATTR, None)
            out.append(placed.axis if placed is not None else
                       tp_rule(name, full_shape(p), model_size, min_shard_dim, name in kernels))
    return tuple(out)


@dataclass(frozen=True)
class Plan:
    """Per parameter, the axis of its model block split over the mesh's
    ``data`` axis (`axes`; None: replicated) and the axis split over its
    ``model`` axis (`model_axes`; empty: none); `shard_params` says whether
    the parameters themselves live sharded over ``data`` (FSDP) or only
    their gradients, moments and EMA (ZeRO-1)."""

    axes: Tuple[Optional[int], ...]
    shard_params: bool = False
    model_axes: Tuple[Optional[int], ...] = ()

    def model_axis(self, i: int) -> Optional[int]:
        return self.model_axes[i] if self.model_axes else None

    def local(self, i: int, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
        """This rank's data block of a model block of parameter i (a view)."""
        axis = self.axes[i]
        if axis is None or mesh is None:
            return t
        k = t.shape[axis] // mesh.size
        return t.narrow(axis, mesh.rank * k, k)

    def block(self, i: int, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
        """This rank's model block of a full tensor of parameter i (a view)."""
        axis = self.model_axis(i)
        if axis is None or mesh is None:
            return t
        k = t.shape[axis] // mesh.model_size
        return t.narrow(axis, mesh.model_rank * k, k)

    def part(self, i: int, full: torch.Tensor, mesh: Optional[Mesh],
             shape: Sequence[int]) -> torch.Tensor:
        """The part of a full tensor of parameter i that a tensor of `shape`
        holds on this rank: the whole, its model block or that block's
        data block."""
        t = full if tuple(full.shape) == tuple(shape) else self.block(i, full, mesh)
        return t if tuple(t.shape) == tuple(shape) else self.local(i, t, mesh)


def _leaves(modules, mesh: Mesh, min_shard_dim: int):
    """(name, model block shape, model axis) of every parameter."""
    axes = model_axes(modules, mesh.model_size, min_shard_dim)
    names = [(name, full_shape(p)) for m in modules for name, p in m.named_parameters()]
    return [(n, block_shape(s, a, mesh.model_size), a) for (n, s), a in zip(names, axes)]


def full_shape(p: torch.Tensor) -> torch.Size:
    """A parameter's whole shape (from its FSDP shard or tensor-parallel
    placement where it has one)."""
    shard = getattr(p, SHARD_ATTR, None) or getattr(p, MODEL_ATTR, None)
    return shard.shape if shard is not None else p.shape


def zero1_plan(modules, mesh: Mesh, *, min_size: int = MIN_SIZE,
               min_shard_dim: int = MIN_SHARD_DIM) -> Plan:
    """ZeRO-1 over the parameters of `modules` (the U-Nets, in order):
    gradients, moments, accumulators and EMA sharded over ``data`` by the
    rule applied to each model block, the parameters replicated over
    ``data`` (``zero1_shardings``) and split over ``model`` by
    :func:`tp_rule`."""
    leaves = _leaves(modules, mesh, min_shard_dim)
    return Plan(tuple(leaf_axis(n, s, mesh.size, min_size) for n, s, _ in leaves),
                model_axes=tuple(a for _, _, a in leaves) if mesh.model_size > 1 else ())


def fsdp_plan(modules, mesh: Mesh, *, min_size: int = MIN_SIZE) -> Plan:
    """FSDP: the parameters sharded too, on the same axes (``fsdp_shardings``);
    a data-only mesh, as the JAX package asserts (``mesh.py:223-226``)."""
    if mesh.model_size > 1:
        raise ValueError("fsdp_plan needs a pure data-parallel mesh (model axis 1), not "
                         f"{mesh.shape}: zero1_plan composes with tensor parallelism")
    return Plan(zero1_plan(modules, mesh, min_size=min_size).axes, shard_params=True)


def replicated_plan(modules, mesh: Mesh, *, min_shard_dim: int = MIN_SHARD_DIM) -> Plan:
    """Plain data parallelism: nothing split over ``data``; on a model axis
    the parameters split by :func:`tp_rule`."""
    leaves = _leaves(modules, mesh, min_shard_dim)
    return Plan((None,) * len(leaves),
                model_axes=tuple(a for _, _, a in leaves) if mesh.model_size > 1 else ())


# --------------------------------------------------------------------------- #
# FSDP parameters                                                              #
# --------------------------------------------------------------------------- #
@dataclass
class ParamShard:
    """An FSDP parameter at rest: its full shape, the sharded axis, this
    rank's block (the master values the optimizer updates) and the mesh."""

    shape: torch.Size
    axis: int
    local: torch.Tensor
    mesh: Mesh


def shard_parameters(params: Sequence[torch.nn.Parameter], plan: Plan, mesh: Mesh) -> None:
    """Put each sharded parameter of `plan` to rest as its block."""
    for i, p in enumerate(params):
        if plan.axes[i] is None or getattr(p, SHARD_ATTR, None) is not None:
            continue
        local = plan.local(i, p.detach(), mesh).contiguous().clone()
        setattr(p, SHARD_ATTR, ParamShard(p.shape, plan.axes[i], local, mesh))
        p.data = local.new_empty(0)


@contextlib.contextmanager
def gathered(params: Iterable[torch.nn.Parameter]) -> Iterator[None]:
    """Inside, every FSDP parameter of `params` holds its full value (all
    ranks of its mesh must enter together); outside, none does. Parameters
    without a shard are left alone, so this is a no-op for the others."""
    todo = [p for p in params if getattr(p, SHARD_ATTR, None) is not None and p.numel() == 0]
    if not todo:
        yield
        return
    by_mesh: Dict[int, List[torch.nn.Parameter]] = {}
    for p in todo:
        by_mesh.setdefault(id(getattr(p, SHARD_ATTR).mesh), []).append(p)
    for group in by_mesh.values():
        shards = [getattr(p, SHARD_ATTR) for p in group]
        fulls = [s.local.new_empty(s.shape) for s in shards]
        _gather(shards[0].mesh.group, [s.local for s in shards], [s.axis for s in shards], fulls)
        for p, full in zip(group, fulls):
            p.data = full
    try:
        yield
    finally:
        for p in todo:
            p.data = p.data.new_empty(0)


# --------------------------------------------------------------------------- #
# gradients, norms and parameters                                              #
# --------------------------------------------------------------------------- #
def _buckets(sizes: Sequence[int], idx: Sequence[int]) -> Iterator[List[int]]:
    bucket, total = [], 0
    for i in idx:
        if bucket and total + sizes[i] > BUCKET_ELEMENTS:
            yield bucket
            bucket, total = [], 0
        bucket.append(i)
        total += sizes[i]
    if bucket:
        yield bucket


def _front(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """`t` with `axis` first, as (n, -1): row r is the r-th block."""
    return t.movedim(axis, 0).reshape(n, -1)


def reduce_gradients(grads: Sequence[Optional[torch.Tensor]], shapes: Sequence[torch.Size],
                     plan: Plan, mesh: Mesh) -> List[torch.Tensor]:
    """Full gradients (None counts as zero) -> each summed over the ranks and
    divided by their number, in float32: a sharded leaf as this rank's block
    (in the parameter's layout), a replicated one whole; each a tensor of
    its own, as a one-device step's gradients are (the optimizer's
    reductions then see the same memory layout)."""
    n = mesh.size
    device = mesh.device
    full = [torch.zeros(s, dtype=torch.float32, device=device) if g is None else g.float()
            for g, s in zip(grads, shapes)]
    out: List[Optional[torch.Tensor]] = [None] * len(full)
    sizes = [g.numel() for g in full]
    sharded = [i for i, a in enumerate(plan.axes) if a is not None]
    whole = [i for i, a in enumerate(plan.axes) if a is None]
    for bucket in _buckets(sizes, whole):
        flat = torch.cat([full[i].reshape(-1) for i in bucket])
        collectives.all_reduce(flat, mesh.group)
        for i, piece in zip(bucket, flat.split([sizes[i] for i in bucket])):
            out[i] = piece.view(full[i].shape).clone()
    for bucket in _buckets(sizes, sharded):
        send = torch.cat([_front(full[i], plan.axes[i], n) for i in bucket], dim=1).reshape(-1)
        recv = send.new_empty(send.numel() // n)
        collectives.reduce_scatter(recv, send, mesh.group)
        for i, piece in zip(bucket, recv.split([sizes[i] // n for i in bucket])):
            front = full[i].movedim(plan.axes[i], 0)
            block = piece.view((front.shape[0] // n,) + tuple(front.shape[1:]))
            out[i] = block.movedim(0, plan.axes[i]).clone(memory_format=torch.contiguous_format)
    torch._foreach_div_(out, float(n))
    return out


def _gather(group: Group, locals_: Sequence[torch.Tensor], axes: Sequence[int],
            fulls: Sequence[torch.Tensor]) -> None:
    """Every rank's block of each tensor all-gathered over `group` into
    `fulls`."""
    n = group.size
    sizes = [t.numel() for t in locals_]
    for bucket in _buckets([s * n for s in sizes], range(len(locals_))):
        dtype = locals_[bucket[0]].dtype
        send = torch.cat([locals_[i].to(dtype).movedim(axes[i], 0).reshape(-1) for i in bucket])
        recv = send.new_empty(send.numel() * n).view(n, -1)
        collectives.all_gather(recv.view(-1), send, group)
        for i, piece in zip(bucket, recv.split([sizes[i] for i in bucket], dim=1)):
            front = fulls[i].movedim(axes[i], 0)
            front.copy_(piece.reshape(front.shape))


def _broadcast(params: Sequence[torch.nn.Parameter], idx: Sequence[int], group: Group) -> None:
    sizes = [p.numel() for p in params]
    for dtype in dict.fromkeys(params[i].dtype for i in idx):
        for bucket in _buckets(sizes, [i for i in idx if params[i].dtype == dtype]):
            flat = torch.cat([params[i].detach().reshape(-1) for i in bucket])
            collectives.broadcast(flat, group)
            for i, piece in zip(bucket, flat.split([sizes[i] for i in bucket])):
                params[i].detach().copy_(piece.view_as(params[i]))


def broadcast_params(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Every parameter set to process 0's value, in buckets of one dtype:
    whole ones over the mesh, a tensor-parallel block over its data group
    (from data index 0, which holds the same model index); those FSDP holds
    as shards are left alone."""
    if mesh.world.size == 1:
        return
    idx = [i for i, p in enumerate(params)
           if getattr(p, SHARD_ATTR, None) is None and getattr(p, MODEL_ATTR, None) is None]
    _broadcast(params, idx, mesh.world)
    placed = [i for i, p in enumerate(params) if getattr(p, MODEL_ATTR, None) is not None]
    if placed and mesh.size > 1:
        _broadcast(params, placed, mesh.group)


def sync_params(params: Sequence[torch.nn.Parameter], plan: Optional[Plan],
                mesh: Optional[Mesh]) -> None:
    """ZeRO-1: each replicated parameter's (or model block's) data blocks,
    updated by their ranks, all-gathered back into the whole (nothing to do
    otherwise)."""
    if plan is None or mesh is None or plan.shard_params:
        return
    idx = [i for i, a in enumerate(plan.axes) if a is not None]
    if not idx:
        return
    _gather(mesh.group, [plan.local(i, params[i].detach(), mesh).contiguous() for i in idx],
            [plan.axes[i] for i in idx], [params[i].detach() for i in idx])


def full_tensors(tensors: Sequence[torch.Tensor], plan: Optional[Plan],
                 mesh: Optional[Mesh], shapes: Sequence[torch.Size]) -> List[torch.Tensor]:
    """Whole tensors (of full `shapes`) from this rank's blocks of sharded
    leaves: data blocks all-gathered over the data group into model blocks,
    then model blocks over the model group (all ranks take part); whole
    leaves are returned as they are."""
    if plan is None or mesh is None:
        return list(tensors)
    out = list(tensors)
    blocks = [block_shape(s, plan.model_axis(i), mesh.model_size) for i, s in enumerate(shapes)]
    idx = [i for i, a in enumerate(plan.axes) if a is not None and tensors[i].shape != blocks[i]]
    fulls = [tensors[i].new_empty(blocks[i]) for i in idx]
    if idx:
        _gather(mesh.group, [tensors[i] for i in idx], [plan.axes[i] for i in idx], fulls)
    for i, f in zip(idx, fulls):
        out[i] = f
    idx = [i for i in range(len(out)) if plan.model_axis(i) is not None
           and out[i].shape != shapes[i]]
    fulls = [out[i].new_empty(shapes[i]) for i in idx]
    if idx:
        _gather(mesh.model_group, [out[i].contiguous() for i in idx],
                [plan.model_axis(i) for i in idx], fulls)
    for i, f in zip(idx, fulls):
        out[i] = f
    return out


def global_norm_fn(plan: Plan, mesh: Mesh, default):
    """The clip's global norm over (local) gradients: `default` (the
    one-device formula) where no leaf is sharded, else the square root of
    every element's square counted once: a leaf's squares are summed over
    the data group where ``data`` splits it and over the model group where
    ``model`` does."""
    sharded = [a is not None for a in plan.axes]
    split = [plan.model_axis(i) is not None for i in range(len(sharded))]
    if not any(sharded) and not any(split):
        return default

    def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack([t.float() for t in torch._foreach_norm(list(grads))]).square()
        zero = torch.zeros_like(norms)
        by_data = torch.tensor(sharded, device=norms.device)
        if not any(split):
            part = torch.where(by_data, norms, zero).sum().reshape(1)
            collectives.all_reduce(part, mesh.group)
            return (part[0] + torch.where(by_data, zero, norms).sum()).sqrt()
        by_model = torch.tensor(split, device=norms.device)
        sums = [torch.where(d & m, norms, zero).sum() for d, m in (
            (by_data, by_model), (~by_data, by_model), (by_data, ~by_model), (~by_data, ~by_model))]
        over_model = torch.stack(sums[:2])
        collectives.all_reduce(over_model, mesh.model_group)
        over_data = torch.stack([over_model[0], sums[2]])
        collectives.all_reduce(over_data, mesh.group)
        return (over_data[0] + over_model[1] + over_data[1] + sums[3]).sqrt()

    return norm


def reckon_state_bytes(shapes: Sequence[Sequence[int]], plan: Optional[Plan],
                       mesh: Optional[Mesh], *, param_bytes: int = 4, mu_bytes: int = 4,
                       ema: bool = True, acc_grads: bool = False) -> int:
    """The bytes one process holds of parameters (of full `shapes`), Adam's
    moments, the accumulators and the EMA under `plan` on `mesh`, from the
    shapes alone: a parameter as its model block (its data block too under
    FSDP), the moments, accumulators and EMA as the data block of that."""
    total = 0
    for i, shape in enumerate(shapes):
        model = plan.model_axis(i) if plan is not None else None
        block = block_shape(shape, model, mesh.model_size if mesh is not None else 1)
        axis = plan.axes[i] if plan is not None else None
        local = int(np.prod(block_shape(block, axis, mesh.size if axis is not None else 1)))
        kept = local if plan is not None and plan.shard_params else int(np.prod(block))
        total += kept * param_bytes + local * (mu_bytes + 4 + 4 * ema + 4 * acc_grads)
    return total


def gather_rows(t: torch.Tensor, mesh: Mesh, total: int) -> torch.Tensor:
    """Every rank's rows of a batch (equal blocks of `total` rows) in rank
    order."""
    out = t.new_empty((total,) + tuple(t.shape[1:]))
    collectives.all_gather(out.view(-1), t.contiguous().view(-1), mesh.group)
    return out
