"""The zstd decoders' MB/s on this host, in threads and in processes.

Decodes ``tests/data/zstd/normal_f32_level1.zst`` (seeded float32 at zstd
level 1: Huffman-coded literals, as trained float32 weights give) 16 times
with the host C decoder in pools of 1, 2, 4 and 8 threads (ctypes lets go
of the GIL during a call) and of 8 processes, and once with the Python
decoder; and reads the committed Orbax fixture ``tests/data/orbax_tiny``
(compressible, match-heavy chunks) leaf by leaf, in one thread and in 8.
Once before torch touches the card and once after, where there is one. One
JSON line per pass. Run from the repository's root::

    python -m minimagen_tpu_torch.tools.zstd_rates
"""
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from minimagen_tpu_torch import orbax_format as of

SAMPLE = os.path.join("tests", "data", "zstd", "normal_f32_level1.zst")
FIXTURE = os.path.join("tests", "data", "orbax_tiny", "tmp", "train_state_orbax")


def rates() -> dict:
    frame = open(SAMPLE, "rb").read()
    out = {}
    for w in (1, 2, 4, 8):
        with ThreadPoolExecutor(w) as pool:
            t0 = time.perf_counter()
            outs = list(pool.map(of.zstd_decompress, [frame] * 16))
            out[f"threads{w}"] = 16 * len(outs[0]) / 1e6 / (time.perf_counter() - t0)
    with ProcessPoolExecutor(8) as pool:
        list(pool.map(of.zstd_decompress, [frame] * 8))  # the workers started
        t0 = time.perf_counter()
        outs = list(pool.map(of.zstd_decompress, [frame] * 16))
        out["processes8"] = 16 * len(outs[0]) / 1e6 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    one = of.zstd_decompress(frame, plain=True)
    out["python_decoder"] = len(one) / 1e6 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    leaves = of.read_checkpoint(FIXTURE)
    dt = time.perf_counter() - t0
    mb = sum(t.numel() * t.element_size() for _, _, t in leaves if t is not None) / 1e6
    out["fixture_serial"] = mb / dt
    store = of.OcdbtReader(FIXTURE)
    names = [".".join(keys) for keys, _, t in leaves if t is not None]
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda n: of.read_zarr(store, n), names))
        out["fixture_threads8"] = mb / (time.perf_counter() - t0)
    return {k: round(v, 2) for k, v in out.items()}


if __name__ == "__main__":
    print(json.dumps({"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
                      "numpy": np.__version__, "python": sys.version.split()[0]}), flush=True)
    print("no torch on the card", json.dumps(rates()), flush=True)
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        print("torch + cuda", json.dumps(rates()), flush=True)
