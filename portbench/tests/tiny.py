"""A tiny cascade and cells for the CPU tests: dim-16 U-Nets at 16/32 px,
the harness's CUDA calls stubbed so a run goes end to end on the CPU."""
from __future__ import annotations

import contextlib
import copy
import json
import os
from unittest import mock

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def tiny_config(name: str = "default_cascade"):
    """`name`'s configuration at dim 16 (32 px SR), seeded weights."""
    cfg = copy.deepcopy(load("configs", name))
    for u in cfg["unets"]:
        u["dim"] = 16
        u["attn_heads"] = 2
    cfg["image_sizes"] = [16, 32]
    cfg["timesteps"] = 100
    cfg["weights"] = {"kind": "seeded"}
    return cfg


def tiny_workload(name: str):
    w = copy.deepcopy(load("workloads", name))
    if w["mode"] == "sample":
        w.update(captions_per_call=3, sample_steps=4, caption_tokens=[2, 6])
    else:
        w.update(batch=2, batches=3, caption_tokens=[2, 6])
    return w


@contextlib.contextmanager
def cpu_cuda():
    """The harness's CUDA calls as no-ops on the CPU."""
    with contextlib.ExitStack() as stack:
        for name, value in (("synchronize", lambda *a, **k: None),
                            ("reset_peak_memory_stats", lambda *a, **k: None),
                            ("max_memory_allocated", lambda *a, **k: 0),
                            ("empty_cache", lambda *a, **k: None),
                            ("get_device_name", lambda *a, **k: "cpu"),
                            ("is_available", lambda: True)):
            stack.enter_context(mock.patch.object(torch.cuda, name, value))
        yield


def run_tiny(cell: str, seed: int = 12345, seconds: float = 0.0, config=None):
    """One run of a tiny copy of `cell` on the CPU; returns the result."""
    from portbench import run

    w = tiny_workload(cell)
    ctx = run.make_context(cell, seed, workload=w, config=config or tiny_config(w["config"]),
                           device="cpu")
    with cpu_cuda():
        return run.run_cell(ctx, seconds, False, run.cell_metrics(cell, False))
