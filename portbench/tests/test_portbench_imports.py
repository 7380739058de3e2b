"""What the harness and the reference import: nothing of JAX, flax or the
JAX package (top-level names compared whole), and the reference nothing of
the program either."""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "minimagen_tpu"}


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = ("import portbench.run, portbench.calibrate, portbench.modes.sample, "
            "portbench.modes.train, portbench.program as p, portbench.trace\n"
            "p.module_classes(); p.launches()\n"
            "from portbench.tests import tiny\n"
            "tiny.run_tiny('lite.ddim50.c64')")
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN
    assert "minimagen_tpu_torch" in loaded  # the port is what runs


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.unet, portbench.reference.cascade")
    assert not loaded & (FORBIDDEN | {"minimagen_tpu_torch"})


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["", "reference", "modes", "metrics", "ranges"])
def test_sources_name_no_jax(sub):
    folder = os.path.join(PKG, sub)
    for name in sorted(os.listdir(folder)):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(folder, name))}
            assert not tops & FORBIDDEN, name
            if sub == "reference":
                assert "minimagen_tpu_torch" not in tops, name
