"""Process groups and collectives: the port's only caller of
``torch.distributed``.

The multi-device modes run one process per device (SPMD), as torch does,
not the JAX package's single controller: every process runs the same
program on its own rows, and a mesh's ``data`` axis is a process group.
Processes are started by ``torchrun`` (:mod:`.multihost` reads its
environment) or by :func:`spawn`, which starts fresh interpreters (never
``fork``: a parent with CUDA state or other threads cannot be forked safely)
that rendezvous through a ``FileStore`` in a directory of their own.

The backend is explicit: NCCL for CUDA devices, one device per process
(``cuda:{LOCAL_RANK}`` unless the caller names one), gloo for the CPU. A
failed NCCL set-up or collective raises; nothing switches backend on its
own. NCCL refuses two processes on one device, so ranks that share a card
use gloo, and gloo takes host tensors: under gloo (and only there) a
collective on a CUDA tensor copies it to host memory, runs there, and
copies the result back. :func:`init_process` says so in a log line.

A mesh with a ``model`` axis splits a group into data groups and model
groups (:func:`mesh_groups`); every collective takes the group it runs over.

The collectives take flat tensors: :func:`all_reduce`, :func:`reduce_scatter`
(under gloo an all-reduce of which each rank keeps its chunk),
:func:`all_gather`, :func:`broadcast`, :func:`broadcast_object`, :func:`isend`,
:func:`recv` and :func:`barrier`.

Run as ``python -m minimagen_tpu_torch.parallel.collectives <dir> <rank>``
it is :func:`spawn`'s child.
"""
from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclass(frozen=True)
class Group:
    """A process group: its members' global ranks in group order, this
    process's rank in it (-1 when it is not a member), the backend and the
    device this process computes on."""

    pg: Any
    ranks: Tuple[int, ...]
    rank: int
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    def staged(self, t: torch.Tensor) -> bool:
        """Whether a collective on `t` goes through host memory (gloo and a
        CUDA tensor)."""
        return self.backend == "gloo" and t.is_cuda


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def resolve_device(device=None, backend: Optional[str] = None) -> torch.device:
    """`device`, a bare ``cuda`` made ``cuda:{LOCAL_RANK}``; by default
    ``cuda:{LOCAL_RANK}`` under NCCL and the CPU otherwise."""
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def init_process(rank: int, world_size: int, *, backend: Optional[str] = None, device=None,
                 init_method: Optional[str] = None, store=None) -> Group:
    """Join the default process group (rendezvous at `init_method` or through
    `store`) and return it as a :class:`Group`. The backend defaults to the
    device's (NCCL for CUDA, gloo for the CPU); NCCL communicators are made
    here, so a failed set-up raises now."""
    if backend is None:
        backend = backend_for(resolve_device(device))
    device = resolve_device(device, backend)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device} ({backend}); a mesh does not "
                               "fall back to the CPU")
        torch.cuda.set_device(device)
    kwargs = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    if backend == "gloo" and device.type == "cuda":
        print(f"collectives: gloo over {world_size} ranks on {device}; CUDA tensors are staged "
              "through host memory for every collective", flush=True)
    return world()


def world() -> Group:
    """The default process group (:func:`init_process` must have run)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process or "
                           "multihost.initialize_distributed first")
    backend = dist.get_backend()
    return Group(None, tuple(range(dist.get_world_size())), dist.get_rank(), backend,
                 _device(backend))


def _device(backend: str) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def new_group(ranks: Sequence[int]) -> Group:
    """A group of the given global ranks; every process of the world must
    call this, members or not, in the same order."""
    ranks = tuple(int(r) for r in ranks)
    pg = dist.new_group(list(ranks))
    me = dist.get_rank()
    backend = dist.get_backend()
    return Group(pg, ranks, ranks.index(me) if me in ranks else -1, backend, _device(backend))


def mesh_groups(group: Group, model_parallel: int) -> Tuple[Group, Group]:
    """This process's data group and model group of `group` laid out as a
    (data, model) grid of ``group.size // model_parallel`` rows: the member
    at position r sits at data index r // model_parallel and model index
    r % model_parallel (``np.reshape(n // mp, mp)``, as the JAX package's
    ``make_mesh`` places devices), so a model group is made of consecutive
    ranks. Every process of the world calls this, in the same order: it
    makes every group of the grid (the model groups, then the data groups),
    and a process outside `group` gets groups it is no member of."""
    n, mp = group.size, int(model_parallel)
    if mp < 1 or n % mp:
        raise ValueError(f"{n} processes do not divide into model groups of {mp}")
    mine = group.ranks.index(dist.get_rank()) if dist.get_rank() in group.ranks else None
    models = [new_group(group.ranks[d * mp:(d + 1) * mp]) for d in range(n // mp)]
    datas = [new_group(group.ranks[m::mp]) for m in range(mp)]
    if mine is None:
        return datas[0], models[0]
    return datas[mine % mp], models[mine // mp]


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# collectives on flat tensors                                                 #
# --------------------------------------------------------------------------- #
def _host(t: torch.Tensor, group: Group) -> torch.Tensor:
    return t.cpu() if group.staged(t) else t


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """`t` reduced over the group, in place; returns `t`."""
    buf = _host(t, group)
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group.pg)
    if buf is not t:
        t.copy_(buf)
    return t


_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group: Group) -> torch.Tensor:
    """`inp` (size * k elements) summed over the group, chunk `rank` of it
    into `out` (k elements). Under gloo it is an all-reduce of `inp` (which
    is overwritten) of which this rank keeps its chunk."""
    if out.numel() * group.size != inp.numel():
        raise ValueError(f"reduce_scatter of {inp.numel()} elements into {out.numel()} "
                         f"x {group.size} ranks")
    if group.backend == "gloo":
        buf = all_reduce(_host(inp, group), group)
        out.copy_(buf.view(group.size, -1)[group.rank].view_as(out))
        return out
    _reduce_scatter_tensor(out, inp, group=group.pg)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's `inp` (k elements) into `out` (size * k), in rank order."""
    if inp.numel() * group.size != out.numel():
        raise ValueError(f"all_gather of {inp.numel()} elements x {group.size} ranks "
                         f"into {out.numel()}")
    if group.backend == "gloo":
        src = _host(inp.contiguous(), group)
        dst = _host(out, group) if group.staged(out) else out
        dist.all_gather(list(dst.view(group.size, -1).unbind(0)), src.view(-1), group=group.pg)
        if dst is not out:
            out.copy_(dst)
        return out
    _all_gather_tensor(out, inp.contiguous(), group=group.pg)
    return out


def broadcast(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """`t` of the group's rank `src` into every rank's `t`, in place."""
    buf = _host(t, group)
    dist.broadcast(buf, group.ranks[src], group=group.pg)
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast_object(obj: Any, group: Group, src: int = 0) -> Any:
    """A picklable object of the group's rank `src`, returned on every rank."""
    box = [obj]
    device = group.device if group.backend == "nccl" else None
    dist.broadcast_object_list(box, group.ranks[src], group=group.pg, device=device)
    return box[0]


def barrier(group: Group) -> None:
    kwargs = {"device_ids": [group.device.index]} if group.backend == "nccl" else {}
    dist.barrier(group=group.pg, **kwargs)


def _wire(t: torch.Tensor, group: Group) -> torch.Tensor:
    """`t` as the backend sends it: on the host under gloo, on the group's
    device under NCCL."""
    if group.backend == "gloo":
        return t.cpu().contiguous()
    return t.to(group.device).contiguous()


class _Sent:
    """An `isend` in flight; keeps the buffer alive until :meth:`wait`."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def isend(t: torch.Tensor, dst: int, group: Group) -> _Sent:
    """`t` to global rank `dst` without waiting; `.wait()` on the result."""
    buf = _wire(t, group)
    return _Sent(dist.isend(buf, dst), buf)


def recv(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Into `t` from global rank `src` (blocking); returns `t`."""
    buf = _wire(torch.empty_like(t), group)
    dist.recv(buf, src)
    t.copy_(buf)
    return t


# --------------------------------------------------------------------------- #
# spawn: fresh interpreters, one per rank                                      #
# --------------------------------------------------------------------------- #
def _child(workdir: str, rank: int) -> None:
    with open(os.path.join(workdir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    world_size = spec["world_size"]
    if spec["rendezvous"] == "env":
        from .multihost import initialize_distributed  # noqa: PLC0415

        initialize_distributed(device=spec["devices"][rank])
        group = world()
    else:
        store = dist.FileStore(os.path.join(workdir, "store"), world_size)
        group = init_process(rank, world_size, backend=spec["backend"],
                             device=spec["devices"][rank], store=store)
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        result = fn(group, *spec["args"])
    finally:
        destroy()
    tmp = os.path.join(workdir, f"result_{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(workdir, f"result_{rank}.pkl"))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def spawn(target: str, world_size: int, args: Sequence[Any] = (), *, backend: str = "gloo",
          devices: Optional[Sequence[Any]] = None, timeout: float = 600.0, threads: int = 1,
          rendezvous: str = "file", env=None,
          echo: Optional[Callable[[str], None]] = None) -> List[Any]:
    """Run ``target(group, *args)`` in `world_size` fresh processes, one per
    rank, and return each rank's result (pickled back) in rank order.

    :param target: ``"module:function"``, importable with this process's
        ``sys.path``; the children import it and nothing else of the caller.
    :param devices: each rank's device (default: ``cuda:{rank}`` under NCCL,
        the CPU under gloo). Ranks that share a device need gloo.
    :param rendezvous: ``"file"`` (a ``FileStore`` in a fresh temporary
        directory) or ``"env"`` (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
        ``WORLD_SIZE`` as torchrun sets them, read by
        :func:`.multihost.initialize_distributed`; `env` supplies the address).
    :param env: extra environment variables: a dict for every rank, or one
        dict per rank.
    :param threads: torch's intra-op threads in each child.
    :param echo: called with each line the children printed, prefixed by the
        rank, once they have ended.
    A child that fails, or a run longer than `timeout` seconds, ends every
    child and raises with the failed ranks' output.
    """
    devices = list(devices) if devices is not None else [
        f"cuda:{r}" if backend == "nccl" else "cpu" for r in range(world_size)]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    if backend == "nccl" and len({str(d) for d in devices}) != world_size:
        raise ValueError("NCCL takes one device per rank; ranks that share a card use gloo")
    with tempfile.TemporaryDirectory(prefix="mmt_spawn_") as workdir:
        with open(os.path.join(workdir, "spec.pkl"), "wb") as f:
            pickle.dump(dict(target=target, world_size=world_size, args=tuple(args),
                             backend=backend, devices=[str(d) for d in devices],
                             threads=threads, rendezvous=rendezvous), f)
        path = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
        procs, logs = [], []
        try:
            envs = env if isinstance(env, (list, tuple)) else [env or {}] * world_size
            for rank in range(world_size):
                child_env = dict(os.environ, PYTHONPATH=path, RANK=str(rank), LOCAL_RANK=str(rank),
                                 WORLD_SIZE=str(world_size), OMP_NUM_THREADS=str(threads),
                                 **envs[rank])
                log_path = os.path.join(workdir, f"log_{rank}.txt")
                logs.append(log_path)
                with open(log_path, "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", __name__, workdir, str(rank)],
                        stdout=log, stderr=subprocess.STDOUT, env=child_env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if echo is not None:
            for rank, log_path in enumerate(logs):
                for line in _tail(log_path, 1 << 20).splitlines():
                    echo(f"[rank {rank}] {line}")
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            detail = "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n{_tail(logs[r])}"
                               for r in bad)
            raise RuntimeError(f"spawn {target} over {world_size} ranks: ranks {bad} failed "
                               f"or timed out after {timeout} s\n{detail}")
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


if __name__ == "__main__":
    try:
        _child(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.exit(1)
