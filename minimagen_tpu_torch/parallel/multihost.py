"""Processes on several hosts (counterpart of
``minimagen_tpu/parallel/multihost.py``).

Each host runs the same program, one process per device; the processes
find each other through the environment, either torchrun's (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or the JAX
package's (``COORDINATOR_ADDRESS`` as host:port, ``NUM_PROCESSES``,
``PROCESS_ID``). Each process feeds its own rows of the global batch, so
:func:`global_batch_from_local` is the identity on them, after checking
that every process holds as many.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import collectives
from .mesh import Mesh, make_mesh


def _rendezvous() -> Optional[tuple]:
    """(address, rank, world size) from the environment, or None."""
    env = os.environ
    if env.get("COORDINATOR_ADDRESS"):
        if not env.get("NUM_PROCESSES"):
            raise ValueError("COORDINATOR_ADDRESS is set without NUM_PROCESSES (and PROCESS_ID)")
        return env["COORDINATOR_ADDRESS"], int(env.get("PROCESS_ID", "0")), int(env["NUM_PROCESSES"])
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and env.get("RANK"):
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        return address, int(env["RANK"]), int(env["WORLD_SIZE"])
    return None


def initialize_distributed(device=None) -> bool:
    """Join the processes the environment describes (NCCL on
    ``cuda:{LOCAL_RANK}`` for a CUDA `device`, gloo otherwise); returns
    whether more than one process is active. Without those variables (and
    no group joined yet) it joins nothing and returns False."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    found = _rendezvous()
    if found is None:
        return False
    address, rank, world_size = found
    collectives.init_process(rank, world_size, device=device, init_method=f"tcp://{address}")
    return world_size > 1


def make_global_mesh(*, model_parallel: int = 1, device=None) -> Mesh:
    """The mesh over every process of every host: the world's ranks in
    order, a host's processes neighbours, and each model group of
    `model_parallel` consecutive ranks within one host (the processes per
    host, torchrun's ``LOCAL_WORLD_SIZE``, must divide by it)."""
    initialize_distributed(device)
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) % model_parallel:
        raise ValueError(f"{local} processes per host do not divide by model_parallel="
                         f"{model_parallel}: a model group would span hosts")
    return make_mesh(model_parallel=model_parallel, device=device)


def global_batch_from_local(batch: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    """This process's rows of the global batch, as they are: the global
    batch is every process's local batch in rank order. Raises unless every
    process holds the same number of rows."""
    n = len(next(iter(batch.values())))
    counts = torch.tensor([n, -n], dtype=torch.int64, device=mesh.device)
    collectives.all_reduce(counts, mesh.group, op="max")
    if int(counts[0]) != -int(counts[1]):
        raise ValueError(f"local batches differ between processes ({-int(counts[1])} to "
                         f"{int(counts[0])} rows)")
    return batch
