"""Tensor parallelism over a mesh's ``model`` axis: the column-parallel
forward (counterpart of the JAX package's GSPMD ``model`` axis, whose
shardings ``infer_param_shardings`` seeds, ``minimagen_tpu/parallel/mesh.py:109-130``).

:func:`place_model` splits, by :func:`.mesh.tp_rule`, the weight of each
wide ``Dense``, ``Conv`` and ``Conv2d`` module of the U-Nets over the model
group: the parameter keeps its name and ``state_dict`` key and holds this
process's block of the output channels (a :class:`.mesh.ModelShard` on it
records the full shape), and the module's class becomes its column-parallel
form. That form computes this process's slice of the output channels and
all-gathers it along the channel axis (:func:`gather_channels`: forward
all-gather, backward this rank's slice of the gradient); the bias, which
stays whole, is added after the gather. Its input's gradient is summed over
the model group (:func:`sum_grad_over`: identity forward, all-reduce
backward). Everything after a gather is computed whole, with the same
numbers, on every process of the model group, so the gradients of the
replicated parameters are equal there and are reduced over the data group
only.

The stem (``CrossEmbedLayer``) merges its kernels into one space-to-depth
kernel, and kernel 8 consumes every output channel: a stem with a split
kernel gathers its weights (a few MB) before the merge, and keeps this
rank's slice of their gradient.

No kernel runs on a split tensor: attention, GroupNorm and the stem's
depth-to-space take whole (gathered) activations, as the JAX package's
Pallas calls do under GSPMD, where they have no sharding rule. The models
import nothing of this module: the mesh code places the layers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..models.layers import Conv, Conv2d, CrossEmbedLayer, Dense, _cast
from ..ops.stem_conv import cross_embed_conv
from . import collectives
from .collectives import Group
from .mesh import MIN_SHARD_DIM, MODEL_ATTR, Mesh, ModelShard, model_axes


def _all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Every model rank's `x` concatenated along `dim`, in rank order (a
    contiguous tensor)."""
    buf = x.new_empty((group.size,) + tuple(x.shape))
    collectives.all_gather(buf.view(-1), x.contiguous().view(-1), group)
    return torch.cat(list(buf.unbind(0)), dim=dim)


class _GatherChannels(torch.autograd.Function):
    """Forward: all-gather along `dim`. Backward: this rank's slice of the
    (whole, equal on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        k = g.shape[ctx.dim] // ctx.group.size
        return g.narrow(ctx.dim, ctx.group.rank * k, k).contiguous(), None, None


class _SumGradOver(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient all-reduced (summed)
    over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.contiguous().clone(), ctx.group), None


def gather_channels(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """`x`, this rank's slice of a tensor along `dim`, gathered whole."""
    return _GatherChannels.apply(x, group, dim)


def sum_grad_over(x: torch.Tensor, group: Group) -> torch.Tensor:
    """`x` as it is, its gradient summed over `group` (where one is taken)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumGradOver.apply(x, group)
    return x


def _group(module) -> Group:
    return getattr(module.weight, MODEL_ATTR).mesh.model_group


def _add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + _cast(bias, y)


class ColumnDense(Dense):
    """A ``Dense`` whose weight holds this rank's output rows."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = _group(self)
        y = F.linear(sum_grad_over(x, group), _cast(self.weight, x))
        return _add_bias(gather_channels(y, group, -1), self.bias)


class ColumnConv2d(Conv2d):
    """A ``Conv2d`` (NCHW) whose weight holds this rank's output channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = _group(self)
        y = self._conv_forward(sum_grad_over(x, group), _cast(self.weight, x), None)
        out = gather_channels(y, group, 1)
        return out if self.bias is None else out + _cast(self.bias, out)[:, None, None]


class ColumnConv(Conv):
    """A ``Conv`` (NHWC) whose weight holds this rank's output channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = _group(self)
        x = sum_grad_over(x, group)
        y = self._conv_forward(x.permute(0, 3, 1, 2), _cast(self.weight, x), None)
        return _add_bias(gather_channels(y.permute(0, 2, 3, 1), group, -1), self.bias)


class GatheredStem(CrossEmbedLayer):
    """A stem whose split kernels are gathered whole before the merge."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"conv_{i}") for i in range(self.num_convs)]
        weights = [c.weight if getattr(c.weight, MODEL_ATTR, None) is None
                   else gather_channels(c.weight, _group(c), 0) for c in convs]
        return cross_embed_conv(x, weights, [c.bias for c in convs], stride=self.stride)


_COLUMN = {Dense: ColumnDense, Conv: ColumnConv, Conv2d: ColumnConv2d}


def place_model(modules: Sequence[torch.nn.Module], mesh: Mesh,
                min_shard_dim: int = MIN_SHARD_DIM,
                axes: Optional[Sequence[Optional[int]]] = None) -> int:
    """Split the wide kernels of `modules` over `mesh`'s model axis (every
    process of the model group calls this with the same whole weights) and
    give their modules the column-parallel forward: by `axes`, one entry per
    parameter of `modules` in order (a plan's ``model_axes``), or else by
    :func:`.mesh.tp_rule` at `min_shard_dim`. Parameters placed already
    keep their placement. Nothing happens on a model axis of 1. Returns the
    number of kernels split here."""
    if mesh.model_size == 1:
        return 0
    n, r = mesh.model_size, mesh.model_rank
    modules = list(modules)
    if axes is None:
        axes = model_axes(modules, n, min_shard_dim)
    axes = iter(axes)
    placed = 0
    for module in modules:
        axis_of = {name: next(axes) for name, _ in module.named_parameters()}
        for name, m in module.named_modules():
            wname = f"{name}.weight" if name else "weight"
            w = getattr(m, "weight", None)
            axis = axis_of.get(wname)
            if axis is None or getattr(w, MODEL_ATTR, None) is not None:
                continue
            if type(m) not in _COLUMN or axis != 0:
                raise ValueError(f"{wname}: only the output axis of a Dense, Conv or Conv2d "
                                 f"weight is split over the model axis, not axis {axis} of "
                                 f"a {type(m).__name__}")
            k = w.shape[axis] // n
            full = w.shape
            w.data = w.data.narrow(axis, r * k, k).contiguous().clone()
            setattr(w, MODEL_ATTR, ModelShard(full, axis, mesh))
            m.__class__ = _COLUMN[type(m)]
            placed += 1
        for m in module.modules():
            if type(m) is CrossEmbedLayer and any(
                    getattr(getattr(m, f"conv_{i}").weight, MODEL_ATTR, None) is not None
                    for i in range(m.num_convs)):
                m.__class__ = GatheredStem
    return placed


def is_placed(module: torch.nn.Module) -> bool:
    """Whether any parameter of `module` is split over a model axis."""
    return any(getattr(p, MODEL_ATTR, None) is not None for p in module.parameters())
