"""Meshes, sharding plans and the collectives of data parallelism, ZeRO-1
and FSDP (counterpart of ``minimagen_tpu/parallel/mesh.py``).

A :class:`Mesh` is a process group seen as the JAX mesh's ``data`` axis
(its ``model`` axis has size 1: tensor parallelism, ROADMAP item 5b, is not
ported). Each process holds its rows of the batch (:func:`shard_batch`).

A :class:`Plan` says, for each parameter of the port's list (U-Net by U-Net,
in module order), which axis is split over the ``data`` axis, by the JAX
package's rule (:func:`zero1_rule`, ``mesh.py:141-159`` copied): the largest
axis divisible by the data size, in the JAX parameter's layout (HWIO
convolutions, (in, out) dense kernels), mapped back onto the port's axis;
scalars, leaves under `min_size` elements and leaves with no divisible axis
are replicated, and at data size 1 everything is. :func:`zero1_plan` shards
the gradients, Adam's moments, the accumulators and the EMA by it;
:func:`fsdp_plan` the parameters too.

The training step (``training.make_train_step(mesh=)``) uses:

- :func:`reduce_gradients`: each gradient summed over the ranks, then
  divided by their number, in float32; a sharded leaf comes back as this
  rank's shard (a reduce-scatter), a replicated one whole (an all-reduce);
- :func:`global_norm_fn`: the norm of clip-50 over every element once
  (sharded leaves' squares summed over ranks, replicated ones counted once);
- :func:`sync_params`: under ZeRO-1 the updated shards all-gathered into the
  replicated parameters;
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
BUCKET_ELEMENTS = 1 << 25  # 128 MiB of float32 per collective
SHARD_ATTR = "_mesh_shard"  # where an FSDP parameter keeps its shard


@dataclass(frozen=True)
class Mesh:
    """The ``data`` axis over a process group; ``model`` is 1."""

    group: Group

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size, "model": 1}

    def rows(self, n: int, *, even: bool = True) -> slice:
        """This rank's rows of `n`: equal blocks (`n` must divide by the
        data size, as the JAX package asserts), or with `even` False blocks
        that differ by at most one row, the larger first."""
        if even and n % self.size:
            raise ValueError(f"a batch of {n} rows does not divide the data axis of {self.size}")
        per, extra = divmod(n, self.size)
        lo = self.rank * per + min(self.rank, extra)
        return slice(lo, lo + per + (self.rank < extra))


def make_mesh(group: Optional[Group] = None, *, model_parallel: int = 1, device=None) -> Mesh:
    """A ('data', 'model') mesh over `group` (default: the world, joined from
    torchrun's or the JAX package's environment by
    :func:`.multihost.initialize_distributed`, else a world of one process on
    `device`). `model_parallel` must be 1."""
    if model_parallel != 1:
        raise NotImplementedError("tensor parallelism over a 'model' axis (ROADMAP item 5b) "
                                  "is not ported: make_mesh takes model_parallel=1 only")
    if group is None:
        if not torch.distributed.is_initialized():
            from .multihost import initialize_distributed  # noqa: PLC0415

            if not initialize_distributed(device):
                if not torch.distributed.is_initialized():
                    collectives.init_process(0, 1, device=device,
                                             store=torch.distributed.HashStore())
        group = collectives.world()
    return Mesh(group)


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


@dataclass(frozen=True)
class Plan:
    """Per parameter, the axis split over the mesh's ``data`` axis (None:
    replicated); `shard_params` says whether the parameters themselves live
    sharded (FSDP) or only their gradients, moments and EMA (ZeRO-1)."""

    axes: Tuple[Optional[int], ...]
    shard_params: bool = False

    def local(self, i: int, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
        """This rank's block of a full tensor of parameter i (a view)."""
        axis = self.axes[i]
        if axis is None or mesh is None:
            return t
        k = t.shape[axis] // mesh.size
        return t.narrow(axis, mesh.rank * k, k)


def _named(modules) -> List[Tuple[str, torch.Size]]:
    return [(name, full_shape(p)) for m in modules for name, p in m.named_parameters()]


def full_shape(p: torch.Tensor) -> torch.Size:
    """A parameter's whole shape (from its shard while FSDP keeps it at rest)."""
    shard = getattr(p, SHARD_ATTR, None)
    return shard.shape if shard is not None else p.shape


def zero1_plan(modules, mesh: Mesh, *, min_size: int = MIN_SIZE) -> Plan:
    """ZeRO-1 over the parameters of `modules` (the U-Nets, in order):
    gradients, moments, accumulators and EMA sharded by the rule, the
    parameters replicated (``zero1_shardings``)."""
    return Plan(tuple(leaf_axis(n, s, mesh.size, min_size) for n, s in _named(modules)))


def fsdp_plan(modules, mesh: Mesh, *, min_size: int = MIN_SIZE) -> Plan:
    """FSDP: the parameters sharded too, on the same axes (``fsdp_shardings``)."""
    return Plan(zero1_plan(modules, mesh, min_size=min_size).axes, shard_params=True)


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
        _gather(shards[0].mesh, [s.local for s in shards], [s.axis for s in shards], fulls)
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


def _gather(mesh: Mesh, locals_: Sequence[torch.Tensor], axes: Sequence[int],
            fulls: Sequence[torch.Tensor]) -> None:
    """Every rank's block of each tensor all-gathered into `fulls`."""
    n = mesh.size
    sizes = [t.numel() for t in locals_]
    for bucket in _buckets([s * n for s in sizes], range(len(locals_))):
        dtype = locals_[bucket[0]].dtype
        send = torch.cat([locals_[i].to(dtype).movedim(axes[i], 0).reshape(-1) for i in bucket])
        recv = send.new_empty(send.numel() * n).view(n, -1)
        collectives.all_gather(recv.view(-1), send, mesh.group)
        for i, piece in zip(bucket, recv.split([sizes[i] for i in bucket], dim=1)):
            front = fulls[i].movedim(axes[i], 0)
            front.copy_(piece.reshape(front.shape))


def broadcast_params(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Every parameter (but those FSDP already holds as shards) set to
    process 0's value, in buckets of one dtype."""
    if mesh.size == 1:
        return
    idx = [i for i, p in enumerate(params) if getattr(p, SHARD_ATTR, None) is None]
    sizes = [p.numel() for p in params]
    for dtype in dict.fromkeys(params[i].dtype for i in idx):
        for bucket in _buckets(sizes, [i for i in idx if params[i].dtype == dtype]):
            flat = torch.cat([params[i].detach().reshape(-1) for i in bucket])
            collectives.broadcast(flat, mesh.group)
            for i, piece in zip(bucket, flat.split([sizes[i] for i in bucket])):
                params[i].detach().copy_(piece.view_as(params[i]))


def sync_params(params: Sequence[torch.nn.Parameter], plan: Optional[Plan],
                mesh: Optional[Mesh]) -> None:
    """ZeRO-1: each replicated parameter's blocks, updated by their ranks,
    all-gathered back into the whole (nothing to do otherwise)."""
    if plan is None or mesh is None or plan.shard_params:
        return
    idx = [i for i, a in enumerate(plan.axes) if a is not None]
    if not idx:
        return
    _gather(mesh, [plan.local(i, params[i].detach(), mesh).contiguous() for i in idx],
            [plan.axes[i] for i in idx], [params[i].detach() for i in idx])


def full_tensors(tensors: Sequence[torch.Tensor], plan: Optional[Plan],
                 mesh: Optional[Mesh], shapes: Sequence[torch.Size]) -> List[torch.Tensor]:
    """Whole tensors from this rank's blocks of sharded leaves (all ranks
    take part); replicated leaves are returned as they are."""
    if plan is None or mesh is None:
        return list(tensors)
    out = list(tensors)
    idx = [i for i, a in enumerate(plan.axes) if a is not None and tensors[i].shape != shapes[i]]
    fulls = [tensors[i].new_empty(shapes[i]) for i in idx]
    if idx:
        _gather(mesh, [tensors[i] for i in idx], [plan.axes[i] for i in idx], fulls)
    for i, f in zip(idx, fulls):
        out[i] = f
    return out


def global_norm_fn(plan: Plan, mesh: Mesh, default):
    """The clip's global norm over (local) gradients: `default` (the
    one-device formula) where no leaf is sharded, else the square root of
    the sharded leaves' squares summed over the ranks plus the replicated
    leaves' squares, each element counted once."""
    sharded = [a is not None for a in plan.axes]
    if not any(sharded):
        return default

    def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack([t.float() for t in torch._foreach_norm(list(grads))]).square()
        mask = torch.tensor(sharded, device=norms.device)
        part = torch.where(mask, norms, torch.zeros_like(norms)).sum().reshape(1)
        collectives.all_reduce(part, mesh.group)
        return (part[0] + torch.where(mask, torch.zeros_like(norms), norms).sum()).sqrt()

    return norm


def gather_rows(t: torch.Tensor, mesh: Mesh, total: int) -> torch.Tensor:
    """Every rank's rows of a batch (equal blocks of `total` rows) in rank
    order."""
    out = t.new_empty((total,) + tuple(t.shape[1:]))
    collectives.all_gather(out.view(-1), t.contiguous().view(-1), mesh.group)
    return out
