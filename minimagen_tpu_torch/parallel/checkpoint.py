"""Full-state dumps of mesh runs, in the port's own sharded format (the JAX
package writes Orbax's, which is not ported).

A dump is a directory ``<root>/dump_<n>/``: ``rank_<r>.ckpt`` for each
process of the mesh (flax msgpack: the step, and each kind of tensor —
params, mu, nu, acc_grads, ema_params — by parameter index: this process's
blocks of the leaves its plan shards and, in process 0's file only, the
whole replicated leaves) and ``manifest.json`` (the world size, the
counters and each leaf's stage, name, full shape and sharded axis).

Every save writes a new ``dump_<n>``. Process 0 writes its manifest once
every process's file is complete, and only then removes the older dumps:
a run that dies while saving leaves its last complete dump in place, and a
directory without a manifest is never read. :func:`load_sharded_state`
restores the newest complete dump onto any world size and plan, reading
one rank file at a time (only those holding a part of what this process
keeps) and refusing a file of another step.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import read_msgpack, write_msgpack
from . import collectives

SHARDED_FORMAT = "minimagen_tpu_torch sharded train state"
MANIFEST = "manifest.json"
DUMP_PREFIX = "dump_"

Box = List[Tuple[int, int]]  # per axis, the [lo, hi) of a block of a leaf


def _rank_file(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank_{rank:05d}.ckpt")


def _dumps(root: str) -> List[str]:
    """The dump directories under `root`, oldest first."""
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root) if d.startswith(DUMP_PREFIX))


def latest_dump(root: str) -> Optional[str]:
    """The newest dump under `root` that has its manifest, or None."""
    done = [d for d in _dumps(root) if os.path.exists(os.path.join(root, d, MANIFEST))]
    return os.path.join(root, done[-1]) if done else None


def _state_kinds(state) -> Dict[str, List[torch.Tensor]]:
    opt = state.opt_state
    kinds = {"params": state.local_params(), "mu": opt.mu, "nu": opt.nu}
    if opt.acc_grads is not None:
        kinds["acc_grads"] = opt.acc_grads
    if state.ema_params is not None:
        kinds["ema_params"] = state.ema_params
    return kinds


def save_sharded_state(root: str, state) -> str:
    """Write `state` (on its mesh, or on one device as a world of one) as a
    new dump under `root`, every process of the mesh taking part; returns
    the dump's directory."""
    mesh, plan = state.mesh, state.plan
    rank, size = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    axes = plan.axes if plan is not None else (None,) * len(state.params)
    name = None
    if rank == 0:
        last = _dumps(root)
        name = f"{DUMP_PREFIX}{int(last[-1][len(DUMP_PREFIX):]) + 1 if last else 1:06d}"
    if mesh is not None:
        name = collectives.broadcast_object(name, mesh.group)
    directory = os.path.join(root, name)
    os.makedirs(directory, exist_ok=True)
    kinds = {kind: {f"{i:05d}": t for i, t in enumerate(ts) if axes[i] is not None or rank == 0}
             for kind, ts in _state_kinds(state).items()}
    path = _rank_file(directory, rank)
    write_msgpack(path + ".tmp", {"step": int(state.step), **kinds})
    os.replace(path + ".tmp", path)
    if mesh is not None:
        collectives.barrier(mesh.group)
    if rank == 0:
        opt = state.opt_state
        manifest = {"format": SHARDED_FORMAT, "world_size": size, "step": int(state.step),
                    "count": int(opt.count), "mini_step": int(opt.mini_step),
                    "gradient_step": int(opt.gradient_step), "kinds": sorted(kinds),
                    "leaves": [{"unet": i, "name": n, "shape": list(s), "axis": a}
                               for (i, n), s, a in zip(state.names, state.shapes, axes)]}
        tmp = os.path.join(directory, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(directory, MANIFEST))
        for old in _dumps(root):
            if old != name:
                shutil.rmtree(os.path.join(root, old), ignore_errors=True)
    if mesh is not None:
        collectives.barrier(mesh.group)
    return directory


def _box(shape: Sequence[int], axis: Optional[int], index: int, parts: int) -> Box:
    box = [(0, int(s)) for s in shape]
    if axis is not None:
        k = int(shape[axis]) // parts
        box[axis] = (index * k, index * k + k)
    return box


def _copy_overlap(dst: torch.Tensor, dst_box: Box, src: torch.Tensor, src_box: Box) -> None:
    """The part of `src` (block `src_box` of a leaf) inside `dst_box` into
    `dst` (that block of the same leaf)."""
    for axis, ((dlo, dhi), (slo, shi)) in enumerate(zip(dst_box, src_box)):
        lo, hi = max(dlo, slo), min(dhi, shi)
        if hi <= lo:
            return
        dst = dst.narrow(axis, lo - dlo, hi - lo)
        src = src.narrow(axis, lo - slo, hi - lo)
    with torch.no_grad():
        dst.copy_(src)


def _overlaps(a: Box, b: Box) -> bool:
    return all(max(alo, blo) < min(ahi, bhi) for (alo, ahi), (blo, bhi) in zip(a, b))


def load_sharded_state(root: str, state):
    """Restore the newest complete dump under `root`, written at any world
    size, into `state` (one device, or any mesh and plan: this process
    keeps its blocks); returns `state`."""
    directory = latest_dump(root)
    if directory is None:
        raise FileNotFoundError(f"{root} holds no complete sharded dump (no {MANIFEST})")
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(f"{directory} holds no sharded train state")
    kinds = _state_kinds(state)
    if sorted(kinds) != manifest["kinds"]:
        raise ValueError(f"{directory}: the dump holds {manifest['kinds']}, the state "
                         f"{sorted(kinds)} (EMA or gradient accumulation differ)")
    leaves = manifest["leaves"]
    want = [(i, n, list(s)) for (i, n), s in zip(state.names, state.shapes)]
    if [(leaf["unet"], leaf["name"], leaf["shape"]) for leaf in leaves] != want:
        raise ValueError(f"{directory}: the dump's parameters differ from the state's")
    world = manifest["world_size"]
    missing = [r for r in range(world) if not os.path.exists(_rank_file(directory, r))]
    if missing:
        raise ValueError(f"{directory}: the files of processes {missing} are missing")
    kinds["params"] = state.param_targets()
    mesh = state.mesh

    def dst_box(i, t):  # the whole leaf, or this process's block of it
        if tuple(t.shape) == tuple(leaves[i]["shape"]):
            return _box(leaves[i]["shape"], None, 0, 1)
        return _box(leaves[i]["shape"], state.plan.axes[i], mesh.rank, mesh.size)

    dst_boxes = {kind: [dst_box(i, t) for i, t in enumerate(ts)] for kind, ts in kinds.items()}
    for r in range(world):
        src_boxes = [_box(leaf["shape"], leaf["axis"], r, world) for leaf in leaves]
        needed = {kind: [i for i, leaf in enumerate(leaves) if (leaf["axis"] is not None or r == 0)
                         and _overlaps(src_boxes[i], boxes[i])]
                  for kind, boxes in dst_boxes.items()}
        if not any(needed.values()):
            continue
        tree = read_msgpack(_rank_file(directory, r))
        if int(tree.get("step", -1)) != manifest["step"]:
            raise ValueError(f"{directory}: process {r}'s file is of step {tree.get('step')}, "
                             f"the manifest of step {manifest['step']}")
        for kind, targets in kinds.items():
            part = tree.pop(kind)
            for i in needed[kind]:
                src = torch.from_numpy(np.ascontiguousarray(part.pop(f"{i:05d}")))
                _copy_overlap(targets[i], dst_boxes[kind][i], src, src_boxes[i])
            del part
        del tree
    opt = state.opt_state
    opt.count, opt.mini_step = manifest["count"], manifest["mini_step"]
    opt.gradient_step = manifest["gradient_step"]
    state.step = manifest["step"]
    return state
