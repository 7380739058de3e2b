"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``portbench/workloads/<name>.json``) names its configuration
(``portbench/configs/<config>.json``) and its mode (``portbench/modes/<mode>.py``);
the per-layer metrics that ``BENCHMARK.json`` lists for the cell are read by
``portbench/metrics/<metric>.py``, each with the host ranges it names
(``RANGES``, each ``portbench/ranges/<range>.py``). Set-up (process start to the window:
imports, the kernel library, weights, warm-up) is ``setup_s``. With
``--trace 0`` the window gives the end-to-end metrics. With ``--trace 1`` the
window is measured alike for the step-time and MFU readings, then
``trace_units`` whole calls or steps run under the profiler for the rest.
Then the program is freed and the reference decides ``correct``.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
CACHE = os.path.join(ROOT, "build", "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "minimagen_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Context:
    name: str
    seed: int
    workload: Dict
    config: Dict
    device: str = "cuda"
    root: str = ROOT
    unet_cfgs: List[Dict] = field(default_factory=list)
    gaps: Dict[str, float] = field(default_factory=dict)  # every gap the check worked out

    def make_weights(self):
        from . import weights  # noqa: PLC0415

        return weights.weights_for(self.config, self.unet_cfgs, self.seed, self.device, self.root)


def make_context(name: str, seed: int, workload: Optional[Dict] = None,
                 config: Optional[Dict] = None, device: str = "cuda") -> Context:
    """The cell `name` (its files, unless `workload`/`config` are given)."""
    from .reference.unet import unet_configs  # noqa: PLC0415

    workload = workload or load_json(HERE, "workloads", f"{name}.json")
    config = config or load_json(HERE, "configs", f"{workload['config']}.json")
    return Context(name, seed, workload, config, device, ROOT, list(unet_configs(config)))


def cell_metrics(name: str, trace: bool) -> List[Dict]:
    """The metrics ``BENCHMARK.json`` lists for cell `name` in this mode."""
    bench = load_json(ROOT, "BENCHMARK.json")
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def device_info(count: int) -> Dict:
    import torch  # noqa: PLC0415

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def allocator_counts() -> Dict[str, int]:
    """The caching allocator's device allocations, frees and retries so far."""
    import torch  # noqa: PLC0415

    try:
        stats = torch.cuda.memory_stats()
    except (RuntimeError, AssertionError):  # no CUDA build: nothing to count
        return {}
    return {k: int(stats.get(k, 0)) for k in ("num_device_alloc", "num_device_free",
                                              "num_alloc_retries")}


class WindowStats:
    """What may hold the host up in the window: Python's collections and the
    caching allocator's device allocations; printed to stderr, never a metric."""

    def __enter__(self):
        self.gc_s, self.gc_runs, self._t = 0.0, 0, 0.0
        self.alloc0 = allocator_counts()
        gc.callbacks.append(self._on_gc)
        return self

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_runs += 1

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._on_gc)
        self.alloc = {k: v - self.alloc0.get(k, 0) for k, v in allocator_counts().items()}

    def report(self, unit_s: List[float], unit: str) -> None:
        line = (f"portbench: window: {self.gc_runs} collections, {self.gc_s:.4f} s; "
                f"allocator {json.dumps(self.alloc)}")
        if unit_s:
            q = sorted(unit_s)
            line += (f"; host s between {unit}s p50 {q[len(q) // 2]:.4f}, "
                     f"p95 {q[int(0.95 * (len(q) - 1))]:.4f}, max {q[-1]:.4f}")
        print(line, file=sys.stderr)


def run_cell(ctx: Context, seconds: float, trace: bool, metrics: List[Dict]) -> Dict:
    """Set up, measure, (trace,) free and check one cell; returns the result."""
    import torch  # noqa: PLC0415

    from . import program  # noqa: PLC0415
    from . import trace as tracing  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; the benchmark does not run on the CPU")
    mode = importlib.import_module(f"portbench.modes.{ctx.workload['mode']}").Mode(ctx)
    mode.setup()
    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()  # what set-up made is never scanned again by a collection in the window
    setup_s = process_age_s()
    torch.cuda.reset_peak_memory_stats()
    with WindowStats() as stats:
        measured = mode.measure(seconds, **({"step_events": True} if trace and mode.unit == "step"
                                            else {}))
    stats.report(measured.get("unit_s", []), mode.unit)
    peak = torch.cuda.max_memory_allocated()
    readings = {"measured": measured}
    result_metrics, breakdown, dev = {}, None, device_info(1)
    dev["memory_peak_bytes"] = int(peak)
    if trace:
        readers = {m["name"]: load_file_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                               "portbench_metric_" + m["name"].replace(".", "_"))
                   for m in metrics}
        ranges = tracing.Ranges()
        for name in dict.fromkeys([*mode.ranges, *(r for reader in readers.values()
                                                   for r in getattr(reader, "RANGES", ()))]):
            spec = load_file_module(os.path.join(HERE, "ranges", f"{name}.py"),
                                    "portbench_range_" + name)
            ranges.add(name, spec.modules(mode.imagen), getattr(spec, "shape", None))
        kernels = program.launches()
        kernels.reset_launch_counts()
        tr = tracing.profile(lambda: mode.traced_units(ctx.workload["trace_units"], ranges),
                             ranges, os.path.join(CACHE, "trace"))
        ranges.remove()
        readings.update(trace=tr, ranges=ranges)
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        print(f"portbench: trace of {tr.units} {mode.unit}s, {len(tr.ops)} device operations, "
              f"{tr.unlinked} without a launch event, {tr.range_device_s(mode.unit):.6g} of "
              f"{sum(op[1] for op in tr.ops) * 1e-6:.6g} device s launched inside the "
              f"{mode.unit}s' ranges; card {power_limit()}", file=sys.stderr)
        print(f"portbench: kernel launches per {mode.unit}: "
              + json.dumps({k: v / tr.units for k, v in kernels.LAUNCHES.items() if v})
              + f"; module calls per {mode.unit}: "
              + json.dumps({k: v / tr.units for k, v in ranges.calls.items()}), file=sys.stderr)
        for m in metrics:
            value = readers[m["name"]].read(readings)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
               "images_per_s": measured.get("images_per_s"),
               "train_images_per_s": measured.get("train_images_per_s")}
        for m in metrics:
            if e2e.get(m["name"]) is not None:
                result_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    window_units = mode.calls if mode.unit == "call" else mode.steps
    t_check = time.perf_counter()
    gc.unfreeze()  # so that release() frees the program's cycles too
    mode.release()
    gaps = ctx.gaps = mode.check()
    print(f"portbench: set-up {setup_s:.2f} s, window {measured['seconds']:.2f} s "
          f"({window_units} {mode.unit}s in all), reference check "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    limits = ctx.workload["limits"]
    compared = {k: {"value": _finite(gaps.get(k, float("inf"))), "limit": lim}
                for k, lim in limits.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    result = {"correct": correct, "attempted": measured["attempted"], "failed": 0,
              "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def _finite(x: float) -> float:
    """A number JSON can hold: a gap that is not finite reads 1e300."""
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every cache inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    import torch  # noqa: PLC0415

    ctx = make_context(args.workload, args.seed)
    cell = {w["name"]: w for w in load_json(ROOT, "BENCHMARK.json")["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("portbench: this cell needs a CUDA device; none found", file=sys.stderr)
        return 2
    result = run_cell(ctx, args.seconds, bool(args.trace), cell_metrics(args.workload,
                                                                       bool(args.trace)))
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
