"""Training, on one device or a mesh, and the training harness
(counterpart of ``minimagen_tpu/parallel/mesh.py:250-447``, of
``minimagen_tpu/training.py`` and of ``examples/train_flagship_tpu.py
--model lite``).

The step:

- :func:`make_optimizer`: global-norm clipping at 50, then Adam (eps 1e-8),
  optionally inside gradient accumulation and with a bfloat16 first moment,
  in optax's arithmetic (:class:`ClippedAdam`).
- :class:`TrainState` and :func:`create_train_state`: the step counter, the
  float32 master parameters of every U-Net, the optimizer's state and,
  optionally, an exponential moving average held as a real float32 copy.
- :func:`make_train_step`: one step sums every stage's loss, runs one
  backward pass, then the optimizer and the EMA. Its random draws come from
  a generator seeded by the caller's seed with the global step folded in,
  so a run repeats exactly. :func:`make_chained_train_step`: K such steps.
  :func:`make_eval_step`: the per-stage losses without gradients.
- On a mesh (``parallel/mesh.py``: one process per device, each with its
  rows of the batch) the same functions run data-parallel, ZeRO-1 or FSDP
  as the state's plan says, and a step equals the one-device step on the
  whole batch: each process makes the whole batch's draws and keeps its
  rows.
- :func:`device_prefetch`: the next batches copied to the card on a side
  stream while the current step runs (on a mesh, this process's rows).
- :func:`train_lite`: the lite cascade trained from a fresh flax-style init
  on the synthetic set with the committed run's recipe (``assets/lite_ckpt/
  meta.json``: its held-out combos, 512 items, batch 16, lr 1e-4, EMA 0.9995;
  that run kept Adam's first moment in bf16, ``mu_dtype=torch.bfloat16``
  here; the default is float32).

The harness (``minimagen_tpu/training.py:93-612``): the reference's flags
(:func:`get_minimagen_parser`), the training directory
(:func:`create_directory`, :func:`save_training_info`), restart and test
parameters, the configs of a ``parameters/`` directory and of a preset
(:func:`get_model_params`, :func:`get_default_args`,
:func:`imagen_config_dict`), and :func:`MinimagenTrain`: epochs, a
checkpoint and validation every ``CHCKPT_NUM`` batches, best-validation
U-Nets in ``state_dicts/``, full-state dumps in ``tmp/`` from which a
restart resumes, a per-batch watchdog and crash dumps. Checkpoints are the
JAX package's flax-msgpack files (``checkpoint.py``); a mesh run's full
state is the port's own sharded directory (``parallel/checkpoint.py``),
restorable at any world size. Not ported: the JAX
package's Orbax dumps of its mesh runs.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import json
import os
import signal
import threading
import time
from argparse import ArgumentParser
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import load_train_state, save_train_state, save_unet_checkpoint
from .data.collate import DataLoader, MinimagenCollator, get_minimagen_dl_opts  # noqa: F401
from .data.dataset import ConceptualCaptions, SyntheticCaptionedImages  # noqa: F401
from .generate import LITE_CKPT_DIR, lite_imagen
from .models.imagen import Imagen
from .models.unet import UnetConfig
from .parallel import collectives
from .parallel import mesh as pmesh
from .parallel.checkpoint import latest_dump, load_sharded_state, save_sharded_state
from .parallel.tensor import place_model
from .utils.profiling import StepTimer
from .utils.progress import ProgressBar

NormFn = Callable[[Sequence[torch.Tensor]], torch.Tensor]
GRAD_CLIP_NORM = 50.0
DATA_SEED = 42  # the seed train_lite's steps fold their step into
MU_DTYPES = {"f32": None, "bf16": torch.bfloat16}  # --MU_DTYPE / --mu-dtype choices


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` and, under accumulation, its
    ``MultiStepsState``: `count` the Adam updates made, `mu` (in the
    optimizer's `mu_dtype`) and `nu` one tensor per parameter; `mini_step`,
    `gradient_step` and `acc_grads` (the running mean of the mini-steps'
    gradients, float32) only where ``accum_iter > 1``. The counters are host
    ints: a step needs no read from the card."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


@dataclass(frozen=True)
class ClippedAdam:
    """Global-norm clipping at 50 followed by Adam (b1 0.9, b2 0.999, eps
    1e-8), optionally inside ``optax.MultiSteps(every_k=accum_iter)``: the
    JAX package's ``make_optimizer`` (``minimagen_tpu/parallel/mesh.py:262-277``)
    in optax's arithmetic, op for op (``optax/_src/transform.py::scale_by_adam``,
    ``clipping.py::clip_by_global_norm``, ``wrappers.py::MultiSteps``):

    - the clip divides by the global norm and multiplies by 50, where the
      norm reaches 50;
    - mu is updated in float32 from the stored mu and the float32 gradient;
    - the update is computed from that unrounded mu; only then is mu rounded
      to `mu_dtype` for storage;
    - under accumulation the gradients are averaged over `accum_iter`
      mini-steps (Welford's ``acc + (g - acc) / (n + 1)``), the clip applies
      to the average, and the parameters move on every `accum_iter`-th call
      only.

    Each operation runs over every parameter at once (``torch._foreach_*``).
    """

    lr: float
    accum_iter: int = 1
    mu_dtype: Optional[torch.dtype] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        acc = ([torch.zeros_like(p, dtype=torch.float32) for p in params]
               if self.accum_iter > 1 else None)
        return AdamState(count=0, mu=mu, nu=nu, acc_grads=acc)

    @staticmethod
    def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The float32 norm over every gradient, without a host sync."""
        return torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(list(grads))]))

    def clip_grads(self, grads: List[torch.Tensor],
                   norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """In place, optax's clip: g where the norm (default:
        :meth:`global_norm` of `grads`) is below 50, else (g / norm) * 50;
        returns the norm."""
        norm = self.global_norm(grads) if norm is None else norm
        below = norm < GRAD_CLIP_NORM
        one = torch.ones((), device=norm.device)
        torch._foreach_div_(grads, torch.where(below, one, norm))
        torch._foreach_mul_(grads, torch.where(below, one, one * GRAD_CLIP_NORM))
        return norm

    def clip(self, params: Sequence[torch.nn.Parameter]) -> torch.Tensor:
        """:meth:`clip_grads` of the parameters' gradients."""
        return self.clip_grads([p.grad for p in params if p.grad is not None])

    def _adam(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdamState) -> None:
        """One Adam update of `params` from float32 `grads` (clipped
        already). The moments are updated in place; the update holds one
        float32 list the size of the parameters (the denominator) and, for a
        bfloat16 first moment, its float32 copy."""
        # mu = (1 - b1) g + b1 mu as a fused multiply-add on the gradient term
        # (XLA contracts it so, and ``add(alpha=)`` is one here), b1 mu taken
        # in float32 with b1 rounded to mu's dtype (JAX's weakly typed 0.9
        # becomes bf16 0.8984375): a bf16 moment gets optax's bits.
        # nu = (1 - b2) g^2 + b2 nu
        b1 = float(torch.tensor(self.b1, dtype=state.mu[0].dtype))
        mu = state.mu if state.mu[0].dtype == torch.float32 else [m.float() for m in state.mu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        state.count += 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(self.b1) ** np.float32(state.count))
        bc2 = float(one - np.float32(self.b2) ** np.float32(state.count))
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        # p - lr (mu / bc1) / denom, as p + (-lr / bc1) mu / denom
        torch._foreach_addcdiv_(params, mu, denom, value=-self.lr / bc1)
        if mu is not state.mu:  # rounded only now, for storage
            for dst, src in zip(state.mu, mu):
                dst.copy_(src)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], state: AdamState,
             grads: Optional[List[torch.Tensor]] = None,
             norm_fn: Optional[NormFn] = None) -> bool:
        """Update `params` in place from float32 `grads` (default: their
        ``.grad``, None counting as zero, as optax updates every leaf);
        returns whether they moved (False on the mini-steps of an
        accumulation). `norm_fn` computes the clip's global norm (default
        :meth:`global_norm`; a mesh's counts each element once over the
        ranks' shards)."""
        params = list(params)
        if grads is None:
            grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                     else p.grad.float() for p in params]
        norm_fn = norm_fn or self.global_norm
        if self.accum_iter <= 1:
            self.clip_grads(grads, norm_fn(grads))
            self._adam(params, grads, state)
            return True
        acc = state.acc_grads
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, state.mini_step + 1)
        torch._foreach_add_(acc, delta)
        if state.mini_step < self.accum_iter - 1:
            state.mini_step += 1
            return False
        self.clip_grads(acc, norm_fn(acc))  # in place; zeroed after the update
        self._adam(params, acc, state)
        torch._foreach_zero_(acc)
        state.mini_step = 0
        state.gradient_step += 1
        return True


def make_optimizer(lr: float, accum_iter: int = 1,
                   mu_dtype: Optional[torch.dtype] = None) -> ClippedAdam:
    """Adam + global-norm clip 50, with `accum_iter`-step gradient
    accumulation and Adam's first moment in `mu_dtype` (default: the
    parameters' dtype): the JAX package's ``make_optimizer``."""
    return ClippedAdam(lr, accum_iter, mu_dtype)


@dataclass
class TrainState:
    """The step counter, the U-Nets' parameters (stage by stage, in module
    order), the optimizer's state, the EMA (a float32 copy, or None) and
    each parameter's (stage, name), the key its checkpoints use. `torn` is
    True while an update is applied, and stays True if one failed halfway:
    the state is then no step of the run (:func:`applying_update`).

    On a mesh (`mesh`, `plan`), the moments, accumulators and EMA of a leaf
    the plan shards hold this process's block of it; under FSDP so do the
    parameters (``parallel.mesh.ParamShard``), whose ``data`` is empty at
    rest. :meth:`local_params` are the tensors the optimizer updates."""

    step: int
    params: List[torch.nn.Parameter]
    opt_state: AdamState
    ema_params: Optional[List[torch.Tensor]] = None
    names: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    torn: bool = False
    mesh: Optional[pmesh.Mesh] = None
    plan: Optional[pmesh.Plan] = None

    def local_params(self) -> List[torch.Tensor]:
        """This process's part of each parameter: the whole (one device,
        replicated leaves), a view of its block (ZeRO-1) or its shard (FSDP)."""
        out = []
        for i, p in enumerate(self.params):
            shard = getattr(p, pmesh.SHARD_ATTR, None)
            if shard is not None:
                out.append(shard.local)
            elif self.plan is None:
                out.append(p.detach())
            else:
                out.append(self.plan.local(i, p.detach(), self.mesh))
        return out

    def param_targets(self) -> List[torch.Tensor]:
        """Where a restore writes each parameter: the whole tensor, or under
        FSDP this process's shard."""
        return [getattr(p, pmesh.SHARD_ATTR).local if hasattr(p, pmesh.SHARD_ATTR)
                else p.detach() for p in self.params]

    @property
    def shapes(self) -> List[torch.Size]:
        """Each parameter's full shape."""
        return [pmesh.full_shape(p) for p in self.params]


def state_bytes(state: TrainState) -> int:
    """The bytes this process holds of `state`'s parameters (whole where
    replicated, its model block under tensor parallelism, its shard under
    FSDP), moments, accumulators and EMA."""
    opt = state.opt_state
    tensors = [*state.param_targets(), *opt.mu, *opt.nu, *(opt.acc_grads or []),
               *(state.ema_params or [])]
    return sum(t.numel() * t.element_size() for t in tensors)


def unet_parameters(imagen: Imagen, stages: Optional[Sequence[int]] = None
                    ) -> List[torch.nn.Parameter]:
    """The U-Nets' parameters (of `stages`, default all), stage by stage, in
    module order."""
    stages = range(imagen.num_unets) if stages is None else stages
    return [p for i in stages for p in imagen.unets[i].parameters()]


def create_train_state(imagen: Imagen, optimizer: ClippedAdam, *, ema: bool = False,
                       mesh: Optional[pmesh.Mesh] = None, plan: Optional[pmesh.Plan] = None,
                       stages: Optional[Sequence[int]] = None) -> TrainState:
    """Fresh state over the U-Nets' parameters (of `stages`, default all);
    `ema` also keeps a float32 copy of them for the moving average. On a
    `mesh`, `plan` (``parallel.mesh.zero1_plan`` / ``fsdp_plan``; default
    ``replicated_plan``: every leaf replicated over ``data``) shards the
    moments, accumulators and EMA, and under FSDP puts the parameters to
    rest as their shards; every process first takes process 0's
    parameters, so that all start from one init however each built its
    imagen. On a ``model`` axis the plan's wide kernels are then split
    (``parallel.tensor.place_model``): each process keeps its block, and
    the moments and EMA of such a leaf live on that block."""
    stages = tuple(range(imagen.num_unets)) if stages is None else tuple(stages)
    params = unet_parameters(imagen, stages)
    names = [(i, name) for i in stages for name, _ in imagen.unets[i].named_parameters()]
    if mesh is not None:
        units = [imagen.unets[i] for i in stages]
        plan = plan if plan is not None else pmesh.replicated_plan(units, mesh)  # plain DP
        pmesh.broadcast_params(params, mesh)
        place_model(units, mesh, axes=plan.model_axes)  # a model axis: split the wide kernels
        if plan.shard_params:
            pmesh.shard_parameters(params, plan, mesh)
    state = TrainState(step=0, params=params, opt_state=None, names=names, mesh=mesh,
                       plan=plan if mesh is not None else None)
    local = [t.contiguous() for t in state.local_params()]
    state.opt_state = optimizer.init(local)
    state.ema_params = [t.float().clone() for t in local] if ema else None
    return state


class _UpdateInProgress:
    """Whether an update is being applied, and the watchdog's message if it
    fired meanwhile (signal handlers run on the main thread, between two
    Python bytecodes: a flag is enough)."""

    active = False
    deferred: Optional[str] = None


@contextmanager
def applying_update(state: TrainState):
    """The block that moves `state` to its next step. A watchdog timeout
    (:class:`_Timeout`) that fires inside it is raised once the block has
    ended, never between its in-place writes; `state.torn` is set for the
    block and stays set if the block raises."""
    _UpdateInProgress.active, _UpdateInProgress.deferred = True, None
    state.torn = True
    try:
        yield
        state.torn = False
    finally:
        _UpdateInProgress.active = False
    if _UpdateInProgress.deferred is not None:
        message, _UpdateInProgress.deferred = _UpdateInProgress.deferred, None
        raise BatchTimeoutError(message)


def fold_in(seed: int, step: int) -> int:
    """A 63-bit generator seed for `step` of the run seeded by `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{int(step)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_train_step(imagen: Imagen, optimizer: ClippedAdam, ema_decay: float = 0.9999, *,
                    mesh: Optional[pmesh.Mesh] = None, stages: Optional[Sequence[int]] = None):
    """fn(state, batch, seed=0, draws=None) -> (state, losses (len(stages),)).

    `batch` = {'image': (b, s, s, 3) in [0, 1], 'encoding': (b, L, d),
    'mask': (b, L)} on the imagen's device: on a `mesh`, this process's b
    rows of a batch of b * data-size. The step sums the losses of `stages`
    (default all), runs one backward pass, then the optimizer and the EMA.
    Its draws come from one generator seeded ``fold_in(seed, step)``, made
    for the whole batch in :meth:`Imagen.stage_draws`'s order, stage by
    stage; `draws`, one dict per stage of injected draws for the whole
    batch, replaces them. A process keeps its rows of them, so a mesh step
    is the one-device step on the whole batch. The EMA update is
    ``ema * d + p * (1 - d)`` in float32, with d and 1 - d rounded to
    float32 as the JAX package computes them. The optimizer, the EMA and the
    step counter are applied inside :func:`applying_update`.

    On a mesh (``mesh.py:315-386``) the state's plan decides the
    collectives: each gradient is summed over the processes and divided by
    their number in float32 (reduce-scattered onto this process's block
    where the plan shards it), the clip's norm counts each element once,
    the optimizer and the EMA update the local blocks, and under ZeRO-1 the
    blocks are all-gathered back into the parameters. Under FSDP the stages
    run one after another: a stage's U-Net is gathered for its forward and
    backward passes, and its gradients are reduce-scattered before the next
    stage is gathered (the losses are a sum, so each stage's backward is
    its own). The losses returned are the whole batch's."""
    d32 = np.float32(ema_decay)
    decay, one_minus = float(d32), float(np.float32(1.0) - d32)
    stages = tuple(range(imagen.num_unets)) if stages is None else tuple(stages)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], seed: int = 0,
                draws: Optional[List[Dict[str, torch.Tensor]]] = None):
        total = batch["image"].shape[0] * (mesh.size if mesh is not None else 1)
        if draws is None:
            gen = torch.Generator(device=imagen.device).manual_seed(fold_in(seed, state.step))
            draws = [imagen.stage_draws(i, total, gen) for i in stages]
        if mesh is not None:
            rows = mesh.rows(total)
            draws = [{k: v[rows] for k, v in d.items()} for d in draws]
        loss_of = lambda i, d: imagen.stage_loss(  # noqa: E731
            i, batch["image"], batch["encoding"], batch["mask"], **d)
        for p in state.params:
            p.grad = None
        if state.plan is not None and state.plan.shard_params:
            losses, grads, shapes = [], [], state.shapes
            for i, d in zip(stages, draws):
                idx = [k for k, (s, _) in enumerate(state.names) if s == i]
                params = [state.params[k] for k in idx]
                with pmesh.gathered(params):
                    loss = loss_of(i, d)
                    loss.backward()
                grads += pmesh.reduce_gradients(
                    [p.grad for p in params], [shapes[k] for k in idx],
                    pmesh.Plan(tuple(state.plan.axes[k] for k in idx), True), mesh)
                for p in params:
                    p.grad = None
                losses.append(loss.detach())
            losses = torch.stack(losses)
        else:
            losses = [loss_of(i, d) for i, d in zip(stages, draws)]
            torch.stack(losses).sum().backward()
            losses = torch.stack([loss.detach() for loss in losses])
        norm_fn = None
        if mesh is None:
            grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                     else p.grad.float() for p in state.params]
        else:
            if not state.plan.shard_params:
                grads = pmesh.reduce_gradients([p.grad for p in state.params],
                                               [p.shape for p in state.params], state.plan, mesh)
                for p in state.params:
                    p.grad = None
            norm_fn = pmesh.global_norm_fn(state.plan, mesh, optimizer.global_norm)
            losses = collectives.all_reduce(losses, mesh.group) / mesh.size
        with applying_update(state):
            local = state.local_params()
            optimizer.step(local, state.opt_state, grads=grads, norm_fn=norm_fn)
            if state.ema_params is not None:
                with torch.no_grad():
                    torch._foreach_mul_(state.ema_params, decay)
                    torch._foreach_add_(state.ema_params, [t.float() for t in local],
                                        alpha=one_minus)
            pmesh.sync_params(state.params, state.plan, mesh)
            state.step += 1
        return state, losses

    return step_fn


def make_chained_train_step(imagen: Imagen, optimizer: ClippedAdam, ema_decay: float = 0.9999,
                            *, mesh: Optional[pmesh.Mesh] = None):
    """fn(state, stacked, seed, n) -> (state, the mean per-stage losses of
    `n` steps) (``mesh.py:389-428``): `stacked` holds K batches stacked
    (K, b, ...), and each step takes batch ``state.step % K``, so chains
    compose exactly like single steps."""
    step_fn = make_train_step(imagen, optimizer, ema_decay, mesh=mesh)

    def chain(state: TrainState, stacked: Dict[str, torch.Tensor], seed: int, n: int):
        k = next(iter(stacked.values())).shape[0]
        total = None
        for _ in range(n):
            state, losses = step_fn(state, {name: v[state.step % k] for name, v in stacked.items()},
                                    seed)
            total = losses if total is None else total + losses
        return state, total / n

    return chain


def make_eval_step(imagen: Imagen, mesh: Optional[pmesh.Mesh] = None):
    """fn(batch, seed) -> the per-stage losses (num_unets,) without
    gradients (``mesh.py:431-447``): each stage's ``stage_loss`` with its
    draws from one generator seeded `seed`, in the documented order, stage
    by stage. On a `mesh` `batch` holds this process's rows (blocks that
    may differ by one row, ``shard_batch(even=False)``); the draws are made
    for the whole batch, and the losses are the whole batch's means."""

    @torch.no_grad()
    def eval_fn(batch: Dict[str, torch.Tensor], seed: int = 0) -> torch.Tensor:
        gen = torch.Generator(device=imagen.device).manual_seed(int(seed))
        if mesh is None:
            return torch.stack([imagen.stage_loss(i, batch["image"], batch["encoding"],
                                                  batch["mask"], generator=gen)
                                for i in range(imagen.num_unets)])
        b = batch["image"].shape[0]
        total = torch.tensor([b], device=imagen.device)
        total = int(collectives.all_reduce(total, mesh.group))
        rows = mesh.rows(total, even=False)
        draws = [{k: v[rows] for k, v in imagen.stage_draws(i, total, gen).items()}
                 for i in range(imagen.num_unets)]
        losses = torch.zeros(imagen.num_unets, device=imagen.device)
        for i in range(imagen.num_unets):
            with pmesh.gathered(imagen.unets[i].parameters()):  # FSDP: a stage at a time
                if b:
                    losses[i] = imagen.stage_loss(i, batch["image"], batch["encoding"],
                                                  batch["mask"], **draws[i])
        if mesh.size == 1:
            return losses
        return collectives.all_reduce(losses * b, mesh.group) / total

    return eval_fn


def device_prefetch(batches, device, size: int = 2, mesh: Optional[pmesh.Mesh] = None,
                    even: bool = True) -> Iterator:
    """Batches of host numpy arrays -> dicts of tensors on `device`, `size`
    batches ahead (``mesh.py:65-106``); on a `mesh`, each cut to this
    process's rows first (``shard_batch``, with `even`).

    On a CUDA device each batch is copied into pinned host memory and sent
    with ``non_blocking=True`` on a side stream, so the copy overlaps the
    step running on the current stream; the current stream waits on the
    copy's event before the batch is handed out, and the tensors are marked
    as used on it for the caching allocator. There is no synchronous
    fallback: pinning or the copy raises. On the CPU the arrays become
    tensors without a copy. None batches (nothing left after the collator
    dropped failed items) pass through; a loader's exception is raised once
    the batches before it are handed out."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        if not batch:
            return batch, None
        if mesh is not None:
            batch = pmesh.shard_batch(batch, mesh, even=even)
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not cuda:
            return host, None
        pinned = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(stream):
            moved = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return moved, (event, pinned)  # the pinned buffers live until the copy is waited on

    pending: collections.deque = collections.deque()
    it = iter(batches)
    error: Optional[BaseException] = None
    exhausted = False

    def pull():
        nonlocal error, exhausted
        if exhausted or error is not None:
            return
        try:
            pending.append(put(next(it)))
        except StopIteration:
            exhausted = True
        except Exception as e:  # noqa: BLE001 - raised after the queued batches
            error = e

    while len(pending) < size and not exhausted and error is None:
        pull()
    while pending:
        batch, copy = pending.popleft()
        if copy is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(copy[0])
            for v in batch.values():
                v.record_stream(current)
        pull()
        yield batch
    if error is not None:
        raise error


def stage_batches(num_items: int, batch: int, size: int, max_length: int, encoder_name: str,
                  combos=None, device="cuda") -> Dict[str, torch.Tensor]:
    """The whole synthetic set as stacked (K, b, ...) tensors on `device`
    (K = num_items // batch), batch k holding items k*b ... k*b + b - 1."""
    ds = SyntheticCaptionedImages(num_items=num_items, side_length=size,
                                  encoder_name=encoder_name, max_length=max_length,
                                  combos=combos, device=device)
    coll = MinimagenCollator(max_length=max_length)
    items = [ds[i] for i in range(num_items)]
    stacks = [coll(items[i * batch:(i + 1) * batch]) for i in range(num_items // batch)]
    return {k: torch.as_tensor(np.stack([s[k] for s in stacks]), device=device)
            for k in stacks[0]}


@dataclass
class LiteRun:
    losses: np.ndarray          # (steps, num_unets) per-step losses
    host_ms_per_step: float     # host clock around the steps, synchronized
    imagen: Imagen
    state: TrainState
    step_fn: Callable           # the run's train step, to go on training
    batches: Dict[str, torch.Tensor]  # the staged (K, b, ...) batches


def train_lite(steps: int, batch: int = 16, *, items: int = 512, seed: int = 0,
               mu_dtype: Optional[torch.dtype] = None, device="cuda") -> LiteRun:
    """Train the lite cascade from a fresh flax-style init (from `seed`) for
    `steps` steps with the committed run's recipe (``assets/lite_ckpt/
    meta.json``): the synthetic set without its held-out combos, `items`
    items staged once as items // batch batches and cycled in order,
    clip-50 Adam at its lr, its EMA decay, float32 master parameters and
    bf16 compute. Adam's first moment is in `mu_dtype` (default float32; the
    committed run kept it in bf16). Returns the per-step losses of both
    stages."""
    with open(os.path.join(LITE_CKPT_DIR, "meta.json")) as f:
        config = json.load(f)["config"]
    held = set(config["held_combos"])
    combos = [i for i in range(18) if i not in held]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        imagen = lite_imagen(config["encoder"], dtype=torch.bfloat16, param_dtype=torch.float32,
                             device=device)
    stacked = stage_batches(items, batch, imagen.image_sizes[-1], config["max_length"],
                            config["encoder"], combos=combos, device=device)
    n_batches = stacked["image"].shape[0]
    optimizer = make_optimizer(config["lr"], mu_dtype=mu_dtype)
    state = create_train_state(imagen, optimizer, ema=config["ema"] > 0)
    step_fn = make_train_step(imagen, optimizer, ema_decay=config["ema"])
    sync = torch.cuda.synchronize if imagen.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        k = state.step % n_batches
        state, step_losses = step_fn(state, {name: v[k] for name, v in stacked.items()},
                                     seed=DATA_SEED)
        losses.append(step_losses)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return LiteRun(losses=torch.stack(losses).float().cpu().numpy(), host_ms_per_step=ms,
                   imagen=imagen, state=state, step_fn=step_fn, batches=stacked)


def get_model_params(parameters_dir: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The U-Net parameter dicts (``unet_<i>_*.json``, in i order) and the
    Imagen parameters (``imagen*.json``) of a parameters directory."""
    im_params = None
    unets_params: List[str] = []
    for file in os.listdir(parameters_dir):
        if file.startswith("imagen"):
            im_params = file
        elif file.startswith("unet_"):
            unets_params.append(file)
    unets_params = sorted(unets_params, key=lambda x: int(x.split("_")[1]))
    loaded = []
    for name in unets_params:
        with open(os.path.join(parameters_dir, name)) as f:
            loaded.append(json.load(f))
    with open(os.path.join(parameters_dir, im_params)) as f:
        return loaded, json.load(f)


def get_default_args(obj) -> Dict[str, Any]:
    """The default arguments of a callable or config class; a preset
    (``Base``, ``Super``, ...) merges its ``defaults`` over UnetConfig's."""
    if inspect.isclass(obj) and issubclass(obj, UnetConfig):
        base = {f.name: f.default for f in dataclasses.fields(UnetConfig)
                if f.default is not dataclasses.MISSING}
        return {**base, **obj.defaults} if obj is not UnetConfig else base
    signature = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    return {k: v.default for k, v in signature.parameters.items()
            if v.default is not inspect.Parameter.empty}


def imagen_config_dict(imagen_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """An Imagen kwargs dict completed with the constructor's defaults, as a
    training directory's ``imagen_params_*.json`` holds it (the same keys,
    order and values as the JAX package writes; the compute options dtype,
    remat, param_dtype and device are not part of it)."""
    skip = ("unets", "dtype", "remat", "param_dtype", "device")
    defaults = {k: v for k, v in get_default_args(Imagen).items() if k not in skip}
    out = {k: v for k, v in {**defaults, **imagen_kwargs}.items() if k not in skip}
    if isinstance(out.get("image_sizes"), tuple):
        out["image_sizes"] = list(out["image_sizes"])
    return out


# --------------------------------------------------------------------------- #
# the harness: flags and the training directory (minimagen_tpu/training.py)   #
# --------------------------------------------------------------------------- #
def get_minimagen_parser() -> ArgumentParser:
    """The reference's 15 training flags with their defaults, and ``--EMA``
    (decay of the weights' moving average; 0 turns it off)."""
    parser = ArgumentParser()
    add = parser.add_argument
    add("-p", "--PARAMETERS", dest="PARAMETERS", default=None, type=str,
        help="Parameters directory to load Imagen from")
    add("-n", "--NUM_WORKERS", dest="NUM_WORKERS", default=0, type=int,
        help="Number of workers for DataLoader")
    add("-b", "--BATCH_SIZE", dest="BATCH_SIZE", default=2, type=int, help="Batch size")
    add("-mw", "--MAX_NUM_WORDS", dest="MAX_NUM_WORDS", default=64, type=int,
        help="Maximum number of words allowed in a caption")
    add("-s", "--IMG_SIDE_LEN", dest="IMG_SIDE_LEN", default=128, type=int,
        help="Side length of square Imagen output images")
    add("-e", "--EPOCHS", dest="EPOCHS", default=5, type=int, help="Number of training epochs")
    add("-t5", "--T5_NAME", dest="T5_NAME", default="t5_base", type=str,
        help="Name of T5 encoder to use")
    add("-f", "--TRAIN_VALID_FRAC", dest="TRAIN_VALID_FRAC", default=0.9, type=float,
        help="Fraction of dataset to use for training (vs. validation)")
    add("-t", "--TIMESTEPS", dest="TIMESTEPS", default=1000, type=int,
        help="Number of timesteps in Diffusion process")
    add("-lr", "--OPTIM_LR", dest="OPTIM_LR", default=0.0001, type=float,
        help="Learning rate for Adam optimizer")
    add("-ai", "--ACCUM_ITER", dest="ACCUM_ITER", default=1, type=int,
        help="Number of batches for gradient accumulation")
    add("-cn", "--CHCKPT_NUM", dest="CHCKPT_NUM", default=500, type=int,
        help="Checkpointing batch number interval")
    add("-vn", "--VALID_NUM", dest="VALID_NUM", default=None, type=int,
        help="Number of validation images to use. If None, uses full amount from train/valid split")
    add("-rd", "--RESTART_DIRECTORY", dest="RESTART_DIRECTORY", default=None, type=str,
        help="Training directory to resume training from if restarting.")
    add("-test", "--TESTING", dest="TESTING", action="store_true",
        help="Whether to test with smaller dataset")
    parser.set_defaults(TESTING=False)
    add("--EMA", dest="EMA", type=float, default=0.0,
        help="EMA decay for model weights (e.g. 0.9999); 0 disables")
    return parser


def load_restart_training_parameters(args, justparams: bool = False):
    """Restore MAX_NUM_WORDS, IMG_SIDE_LEN, T5_NAME and TIMESTEPS from a run's
    ``parameters/training_*.txt`` (the restart directory's, or
    ``args.PARAMETERS`` with `justparams`)."""
    params = args.PARAMETERS if justparams else os.path.join(args.RESTART_DIRECTORY, "parameters")
    file = [f for f in os.listdir(params) if f.startswith("training_")][0]
    with open(os.path.join(params, file)) as f:
        lines = f.readlines()
    keep = ("MAX_NUM_WORDS", "IMG_SIDE_LEN", "T5_NAME", "TIMESTEPS")
    restored: Dict[str, Any] = {}
    for line in lines:
        if not any(line.startswith(f"--{k}") for k in keep):
            continue
        key, _, value = line.partition("=")
        value = value.rstrip("\n")
        try:
            restored[key[2:]] = int(value)
        except ValueError:
            restored[key[2:]] = value
    args.__dict__ = {**args.__dict__, **restored}
    return args


def load_testing_parameters(args):
    """The reference's small test values."""
    args.__dict__ = {**args.__dict__, **dict(
        BATCH_SIZE=2, MAX_NUM_WORDS=32, IMG_SIDE_LEN=128, EPOCHS=2, T5_NAME="t5_small",
        TRAIN_VALID_FRAC=0.5, TIMESTEPS=25, OPTIM_LR=0.0001)}
    return args


def create_directory(dir_path: str):
    """Make `dir_path` with ``parameters/``, ``state_dicts/`` and ``tmp/``;
    returns a context manager that changes into it (or a subdirectory) and
    back."""
    original_dir = os.getcwd()
    dir_path = os.path.abspath(dir_path)
    if not os.path.exists(dir_path):
        for sub in ("parameters", "state_dicts", "tmp"):
            os.makedirs(os.path.join(dir_path, sub))

    @contextmanager
    def cm(subpath: str = ""):
        os.chdir(os.path.join(dir_path, subpath))
        try:
            yield
        finally:
            os.chdir(original_dir)

    return cm


def get_model_size(imagen: Imagen) -> float:
    """MB of the U-Nets' parameters and the diffusion schedules' buffers."""
    param_bytes = sum(p.numel() * p.element_size() for p in unet_parameters(imagen))
    buffer_bytes = sum(t.numel() * t.element_size()
                       for sched in (*imagen.noise_schedulers, imagen.lowres_noise_schedule)
                       for t in vars(sched).values() if isinstance(t, torch.Tensor))
    return (param_bytes + buffer_bytes) / 1024 ** 2


def save_training_info(args, timestamp: str, unets_params: List[dict], imagen_params: dict,
                       model_size: float, training_dir) -> None:
    """Write ``parameters/training_parameters_<ts>.txt`` (every flag), the
    model size to ``training_progess.txt`` [sic, the reference's name] and
    the U-Net and Imagen JSON configs."""
    with training_dir("parameters"):
        with open(f"training_parameters_{timestamp}.txt", "w") as f:
            for k in args.__dict__.keys():
                f.write(f"--{k}={getattr(args, k)}\n")
    with training_dir():
        with open(PROGRESS_FILE, "a") as f:
            if getattr(args, "RESTART_DIRECTORY", None) is not None:
                f.write(f"STARTED FROM CHECKPOINT {args.RESTART_DIRECTORY}\n")
            f.write(f"model size: {model_size:.3f}MB\n\n")
    with training_dir("parameters"):
        for idx, param in enumerate(unets_params):
            with open(f"unet_{idx}_params_{timestamp}.json", "w") as f:
                json.dump(param, f, indent=4)
        with open(f"imagen_params_{timestamp}.json", "w") as f:
            json.dump(imagen_params, f, indent=4)


# --------------------------------------------------------------------------- #
# the training loop (minimagen_tpu/training.py:357-612)                        #
# --------------------------------------------------------------------------- #
PROGRESS_FILE = "training_progess.txt"  # [sic], the reference's file name
CKPT_EXT = "ckpt"
TRAIN_STATE_FILE = "train_state.ckpt"
SHARDED_STATE_DIR = "train_state_sharded"  # the full-state dumps of mesh runs
ORBAX_STATE_DIR = "train_state_orbax"  # the JAX package's mesh-run dumps


class BatchTimeoutError(Exception):
    """A training batch exceeded the watchdog's time (skipped, not fatal)."""


class _Timeout:
    """Per-batch SIGALRM watchdog: raises :class:`BatchTimeoutError` if the
    block runs longer than `seconds` (once the update has ended, if one is
    being applied: :func:`applying_update`). Off when `seconds` is falsy, off the
    main thread, or where there is no SIGALRM."""

    def __init__(self, seconds: Optional[int]):
        self.seconds = seconds
        self.active = bool(seconds) and hasattr(signal, "SIGALRM") and (
            threading.current_thread() is threading.main_thread())

    def _handler(self, signum, frame):
        message = f"batch exceeded {self.seconds}s watchdog"
        if _UpdateInProgress.active:  # raised by applying_update once the update ends
            _UpdateInProgress.deferred = message
            return
        raise BatchTimeoutError(message)

    def __enter__(self):
        if self.active:
            self._prev = signal.signal(signal.SIGALRM, self._handler)
            signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        if self.active:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._prev)
        return False


def _maybe_len(loader) -> Optional[int]:
    try:
        return len(loader)
    except TypeError:
        return None


@contextmanager
def swapped_params(state: TrainState):
    """The U-Nets run with the EMA weights inside (the raw parameters put
    back after); without an EMA, unchanged. On a mesh each process swaps
    its blocks, and ZeRO-1 all-gathers them (every process takes part)."""
    if state.ema_params is None:
        yield
        return
    local = state.local_params()
    with torch.no_grad():
        raw = [t.clone() for t in local]
        torch._foreach_copy_(local, state.ema_params)
        pmesh.sync_params(state.params, state.plan, state.mesh)
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_(local, raw)
            pmesh.sync_params(state.params, state.plan, state.mesh)


def load_dump(path: str, state: TrainState) -> TrainState:
    """Restore a full-state dump into `state`: a ``train_state.ckpt`` of
    either package (one device), or a sharded directory of a mesh run."""
    if os.path.isdir(path):
        return load_sharded_state(path, state)
    return load_train_state(path, state)


def MinimagenTrain(timestamp, args, unets, imagen: Imagen, train_dataloader, valid_dataloader,
                   training_dir, optimizer: Optional[ClippedAdam] = None, timeout: int = 60,
                   mesh=None, seed: int = 0) -> Dict[str, Any]:
    """Train every U-Net of `imagen` over ``args.EPOCHS`` epochs of
    `train_dataloader` (the reference's ``MinimagenTrain``; one summed step
    for all stages per batch).

    Every ``args.CHCKPT_NUM`` batches (batch 0 included) the latest weights
    (the EMA when ``args.EMA`` > 0) and the full train state go to ``tmp/``,
    every stage is validated on `valid_dataloader` and a stage that beats
    its best validation loss is written to ``state_dicts/``; the progress
    goes to ``training_progess.txt``. A restart (``args.RESTART_DIRECTORY``)
    resumes from its ``tmp/train_state.ckpt``: parameters, Adam's moments,
    the step and the EMA. A batch of which the collator left nothing is
    skipped; a batch hung past `timeout` seconds is skipped (an epoch's
    first batch is exempt: the run's first builds the kernels); a failing
    batch dumps the state to ``tmp/`` and training goes on, but where the
    failure tore the update halfway (``TrainState.torn``) the last dump is
    restored instead (and with none to restore, the run raises); a failing
    loader dumps the state and ends the epoch. The final state is dumped
    too.

    :param unets: the U-Net configs (the reference's signature; `imagen`'s
        are used).
    :param optimizer: default: clip-50 Adam at ``args.OPTIM_LR`` with
        ``args.ACCUM_ITER`` accumulation.
    :param mesh: a ``parallel.mesh.Mesh``: every process of it runs this
        with the same arguments and loaders (the same global batches, of
        which each takes its rows by data index). ``args.ZERO1`` picks the
        sharding where the data axis has more than one process: 'on'
        (ZeRO-1, the default), 'fsdp' or 'off'; on a ``model`` axis the wide
        kernels are split over it and 'fsdp' takes ZeRO-1, as the JAX
        package does. Validation runs on the mesh. Process 0 writes the
        progress log and the U-Net checkpoints, gathered whole;
        the full state goes to ``tmp/train_state_sharded/`` (``parallel.
        checkpoint``: a new dump each time, a file per process and process
        0's manifest, the older dumps removed once it is complete), which a
        restart at any world size resumes from; a
        restart also takes a one-device run's ``tmp/train_state.ckpt``, on a
        mesh or not. With more than one process the watchdog is off (the
        processes could not agree on a skipped batch).
    :return: {'best_valid_loss', 'history', 'final_step', 'perf',
        'start_step', 'start_adam_count', 'loader_s'}; every loss and
        timing of the run.
    """
    num_unets = imagen.num_unets
    device = imagen.device
    optimizer = optimizer if optimizer is not None else make_optimizer(
        args.OPTIM_LR, getattr(args, "ACCUM_ITER", 1))
    ema_decay = float(getattr(args, "EMA", 0.0) or 0.0)
    plan = None
    shard_mode = getattr(args, "ZERO1", "on")
    if mesh is not None and mesh.size > 1 and shard_mode != "off":
        # FSDP on a data-only mesh; with a model axis, tensor parallelism
        # plus ZeRO-1 (minimagen_tpu/training.py:418-440)
        fsdp = shard_mode == "fsdp" and mesh.model_size == 1
        plan = (pmesh.fsdp_plan if fsdp else pmesh.zero1_plan)(imagen.unets, mesh)
    state = create_train_state(imagen, optimizer, ema=ema_decay > 0.0, mesh=mesh, plan=plan)
    writer = mesh is None or mesh.is_leader
    if mesh is not None and mesh.world.size > 1:
        timeout = None

    last_dump: Optional[str] = None  # the full-state dump a torn update goes back to
    restart_dir = getattr(args, "RESTART_DIRECTORY", None)
    if restart_dir is not None:
        ts_path = os.path.join(restart_dir, "tmp", TRAIN_STATE_FILE)
        sharded_path = os.path.join(restart_dir, "tmp", SHARDED_STATE_DIR)
        if latest_dump(sharded_path) is not None:
            last_dump = os.path.abspath(sharded_path)
        elif os.path.exists(ts_path):
            last_dump = os.path.abspath(ts_path)
        elif os.path.isdir(os.path.join(restart_dir, "tmp", ORBAX_STATE_DIR)):
            raise NotImplementedError(
                f"{restart_dir}/tmp holds only an Orbax dump of the JAX package; Orbax's "
                f"format is not ported (restart from a {TRAIN_STATE_FILE} or "
                f"{SHARDED_STATE_DIR}/ dump)")
        if last_dump is not None:
            load_dump(last_dump, state)
            print(f"Restored full train state (step {state.step}) from {last_dump}")
    start_step, start_count = state.step, state.opt_state.count
    train_step = make_train_step(imagen, optimizer, ema_decay=ema_decay or 0.9999, mesh=mesh)
    eval_step = make_eval_step(imagen, mesh)

    def progress(text: str) -> None:
        if not writer:
            return
        with training_dir():
            with open(PROGRESS_FILE, "a") as f:
                f.write(text)

    def unet_weights() -> List[Dict[str, torch.Tensor]]:
        """Each U-Net's validation weights (the EMA when it is kept), by
        name, whole (every process of a mesh takes part)."""
        weights = state.ema_params if state.ema_params is not None else state.local_params()
        weights = pmesh.full_tensors(weights, state.plan, state.mesh, state.shapes)
        return [{name: t for (stage, name), t in zip(state.names, weights) if stage == i}
                for i in range(num_unets)]

    def dump_tmp() -> None:
        nonlocal last_dump
        weights = unet_weights()
        with training_dir("tmp"):
            if writer:
                for i in range(num_unets):
                    save_unet_checkpoint(f"unet_{i}_tmp.{CKPT_EXT}", weights[i])
            if mesh is None:
                save_train_state(TRAIN_STATE_FILE, state)
                last_dump = os.path.abspath(TRAIN_STATE_FILE)
            else:
                save_sharded_state(SHARDED_STATE_DIR, state)
                last_dump = os.path.abspath(SHARDED_STATE_DIR)

    def restore_last_dump(error: BaseException) -> None:
        """After an update that failed halfway: the last full-state dump."""
        if last_dump is None:
            raise RuntimeError("an update failed halfway and no full-state dump exists to "
                               "restore") from error
        load_dump(last_dump, state)
        pmesh.sync_params(state.params, state.plan, state.mesh)
        state.torn = False
        progress(f"STATE RESTORED FROM {last_dump} (STEP {state.step})\n")

    def validate(epoch_seed: int) -> np.ndarray:
        running = torch.zeros(num_unets, device=device)
        n_batches = 0
        vbar = ProgressBar(total=_maybe_len(valid_dataloader), desc="validation")
        with swapped_params(state):
            for vbatch in device_prefetch(valid_dataloader, device, mesh=mesh, even=False):
                vbar.update()
                if not vbatch:
                    continue
                running += eval_step(vbatch, fold_in(epoch_seed, n_batches))
                n_batches += 1
        vbar.close()
        return running.cpu().numpy().astype(np.float64) / max(n_batches, 1)

    best_loss = np.full(num_unets, 9999999.0)
    history: List[Dict[str, Any]] = []
    timer = StepTimer(device)
    loader_s = 0.0
    for epoch in range(args.EPOCHS):
        print(f'\n{"-" * 20} EPOCH {epoch + 1} {"-" * 20}')
        progress(f'{"-" * 20} EPOCH {epoch + 1} {"-" * 20}\n')
        epoch_seed = fold_in(seed, epoch)
        running_train_loss = np.zeros(num_unets)
        print(f'\n{"-" * 10}Training...{"-" * 10}')
        batch_iter = device_prefetch(train_dataloader, device, mesh=mesh)
        batch_num = -1
        bar = ProgressBar(total=_maybe_len(train_dataloader), desc=f"epoch {epoch + 1} train")
        while True:
            t_fetch = time.perf_counter()
            try:
                batch = next(batch_iter)
            except StopIteration:
                break
            except Exception as e:  # noqa: BLE001 - the loader failed: dump, end the epoch
                progress(f"\n\nDATA LOADER FAILED AT EPOCH {epoch} with exception {e}. "
                         "MOST RECENT STATE DICTS SAVED TO ./tmp IN TRAINING FOLDER\n")
                dump_tmp()
                break
            loader_s += time.perf_counter() - t_fetch
            batch_num += 1
            bar.update()
            try:
                if not batch:
                    continue
                with _Timeout(timeout if batch_num > 0 else None):  # batch 0: the build
                    with timer.step():
                        state, losses = train_step(state, batch, epoch_seed)
                        losses_np = losses.float().cpu().numpy()
                running_train_loss += losses_np
                if batch_num % args.CHCKPT_NUM == 0:
                    progress(f'{"-" * 10}Checkpoint created at batch number {batch_num}'
                             f'{"-" * 10}\n')
                    dump_tmp()
                    avg_loss = running_train_loss / max(batch_num, 1)
                    progress(f"U-Nets Avg Train Losses Epoch {epoch + 1} Batch {batch_num}: "
                             f"{[round(float(i), 3) for i in avg_loss]}\n"
                             f"U-Nets Batch Train Losses Epoch {epoch + 1} Batch {batch_num}: "
                             f"{[round(float(i), 3) for i in losses_np]}\n")
                    print(f'\n{"-" * 10}Validation...{"-" * 10}')
                    avg_valid = validate(fold_in(epoch_seed, 10_000 + batch_num))
                    better = [i for i, loss in enumerate(avg_valid) if loss < best_loss[i]]
                    for i, loss in enumerate(avg_valid):
                        print(f"Unet {i} avg validation loss: ", loss)
                    if better:
                        weights = unet_weights()
                        for i in better:
                            best_loss[i] = avg_valid[i]
                            if writer:
                                with training_dir("state_dicts"):
                                    save_unet_checkpoint(
                                        f"unet_{i}_state_{timestamp}.{CKPT_EXT}", weights[i])
                    perf = timer.summary()
                    progress(f"U-Nets Avg Valid Losses: {[round(float(i), 3) for i in avg_valid]}\n"
                             f"U-Nets Best Valid Losses: {[round(float(i), 3) for i in best_loss]}"
                             f"\n\nTrain steps/sec: {perf['steps_per_sec']:.3f}\n")
                    history.append({"epoch": epoch, "batch": batch_num, "train": avg_loss.tolist(),
                                    "valid": avg_valid.tolist(), "batch_train": losses_np.tolist(),
                                    "steps_per_sec": perf["steps_per_sec"]})
            except KeyboardInterrupt:
                raise
            except BatchTimeoutError as e:
                progress(f"BATCH {batch_num} EPOCH {epoch} SKIPPED: {e}\n")
                if state.torn:
                    restore_last_dump(e)
                continue
            except Exception as e:  # noqa: BLE001 - dump and go on with the next batch
                progress(f"\n\nTRAINING ABORTED AT EPOCH {epoch}, BATCH NUMBER {batch_num} "
                         f"with exception {e}. ")
                if state.torn:  # a dump of this state would overwrite the last good one
                    progress("THE UPDATE FAILED HALFWAY. ")
                    restore_last_dump(e)
                else:
                    progress("MOST RECENT STATE DICTS SAVED TO ./tmp IN TRAINING FOLDER")
                    dump_tmp()
        bar.close()

    dump_tmp()
    if state.ema_params is not None:  # the instance keeps the weights it was validated with
        with torch.no_grad():
            torch._foreach_copy_(state.local_params(), state.ema_params)
            pmesh.sync_params(state.params, state.plan, state.mesh)
    return {"best_valid_loss": best_loss.tolist(), "history": history,
            "final_step": state.step, "perf": timer.summary(), "start_step": start_step,
            "start_adam_count": start_count, "adam_count": state.opt_state.count,
            "loader_s": loader_s}


def window_means(losses: np.ndarray, width: int = 200) -> List[List[float]]:
    """Each stage's mean loss over consecutive `width`-step windows (the rows
    of the committed run's history.json)."""
    return [losses[i:i + width].mean(axis=0).tolist()
            for i in range(0, len(losses) - width + 1, width)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m minimagen_tpu_torch.training [--steps 400] [--seed 0]
    [--mu-dtype f32|bf16]``: run :func:`train_lite` and print one JSON line
    with the seed, Adam's first-moment dtype, each stage's mean loss over
    every 200-step window and the host ms per step."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mu-dtype", choices=["f32", "bf16"], default="f32")
    args = p.parse_args(argv)
    run = train_lite(args.steps, seed=args.seed, mu_dtype=MU_DTYPES[args.mu_dtype])
    print(json.dumps({"seed": args.seed, "steps": args.steps, "mu_dtype": args.mu_dtype,
                      "finite": bool(np.isfinite(run.losses).all()),
                      "window_means": window_means(run.losses),
                      "host_ms_per_step": run.host_ms_per_step}), flush=True)


if __name__ == "__main__":
    main()
