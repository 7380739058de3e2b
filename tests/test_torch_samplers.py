"""The port's sampling grids and solver coefficients against the JAX
package's, with no U-Net: the ``time``, ``lambda`` and ``karras`` grids of
``strided_sampling_timesteps`` and the DPM-Solver++(2M) and UniPC-2
coefficients, for full and truncated pair sets, must be the same arrays
(``np.array_equal``); and the golden check of ``tests/test_dpmpp.py`` and
``tests/test_unipc.py``: with a constant x0 prediction both solvers follow
the DDIM trajectory (the port's ``ddim_step``) step by step. Also the
port's import boundary: no JAX, flax, msgpack, transformers or
``minimagen_tpu`` anywhere in it or in ``chip_smoke.py``, and PIL (absent on
the card's machine) only inside a function."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

from minimagen_tpu.ops.diffusion import create_gaussian_diffusion
from minimagen_tpu_torch.ops.diffusion import GaussianDiffusion

GRIDS = ("time", "lambda", "karras")


@pytest.fixture(scope="module")
def schedules():
    return {T: (create_gaussian_diffusion(T), GaussianDiffusion(T, "cpu")) for T in (100, 1000)}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("steps", [1, 2, 7, 10, 50])
@pytest.mark.parametrize("T", [100, 1000])
def test_grids_and_coefficients_equal_jax(schedules, T, steps, grid):
    ref, ours = schedules[T]
    want = np.asarray(ref.strided_sampling_timesteps(steps, grid))
    got = ours.strided_sampling_timesteps(steps, grid)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert len(got) <= steps  # duplicates collapse on the lambda and karras grids
    # the full set, then pairs truncated as a super-resolution start filters them
    for start_at in (T - 1, int(0.55 * T), int(0.2 * T)):
        pairs = want[want[:, 0] <= start_at]
        if not len(pairs):
            continue
        for name in ("dpmpp_2m_coefficients", "unipc_c_coefficients"):
            a, b = getattr(ours, name)(pairs), getattr(ref, name)(pairs)
            assert a.dtype == np.float32 and np.array_equal(a, b), (name, start_at)


def test_unknown_grid_and_step_counts_raise():
    sched = GaussianDiffusion(100, "cpu")
    with pytest.raises(ValueError):
        sched.strided_sampling_timesteps(10, "cosine")
    with pytest.raises(ValueError):
        sched.strided_sampling_timesteps(101)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("sampler", ["dpmpp", "unipc"])
def test_constant_x0_follows_ddim(sampler, grid):
    """x0(x, t) = C: DPM++'s blend is C and its coefficient reduces to
    DDIM's; UniPC's difference terms vanish and its corrector maps the exact
    point to itself. Held after every step, before the last one returns x0."""
    sched = GaussianDiffusion(80, "cpu")
    pairs = sched.strided_sampling_timesteps(12, grid)
    pc = sched.dpmpp_2m_coefficients(pairs).tolist()
    cc = sched.unipc_c_coefficients(pairs).tolist()
    gen = torch.Generator().manual_seed(1)
    x0 = torch.rand(2, 4, 4, 3, generator=gen) * 2 - 1
    x_ddim = x = torch.randn(2, 4, 4, 3, generator=gen)
    x0_prev = x_s0 = m0 = m1 = torch.zeros_like(x0)
    full = lambda v: torch.full((2,), int(v))  # noqa: E731
    for i, (t, tp) in enumerate(pairs):
        x_ddim = sched.ddim_step(x_ddim, x0, full(t), full(tp))
        if sampler == "dpmpp":
            x = pc[i][0] * x + pc[i][1] * (pc[i][2] * x0 + pc[i][3] * x0_prev)
            x0_prev = x0
        else:
            x_c = (cc[i][0] * x + cc[i][1] * x_s0 + cc[i][2] * m0
                   + cc[i][3] * (m1 - m0) + cc[i][4] * (x0 - m0))
            x = pc[i][0] * x_c + pc[i][1] * (pc[i][2] * x0 + pc[i][3] * m0)
            x_s0, m1, m0 = x_c, m0, x0
        torch.testing.assert_close(x, x_ddim, atol=2e-5, rtol=1e-5)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "transformers", "minimagen_tpu"}


class _Imports(ast.NodeVisitor):
    def __init__(self):
        self.found, self.depth = [], 0

    def visit_FunctionDef(self, node):
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Import(self, node):
        self.found += [(a.name.split(".")[0], self.depth, node.lineno) for a in node.names]

    def visit_ImportFrom(self, node):
        if node.level == 0:
            self.found.append((node.module.split(".")[0], self.depth, node.lineno))


def test_port_imports_stay_inside_the_boundary():
    files = sorted(glob.glob(os.path.join(REPO, "minimagen_tpu_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    bad = []
    for path in files:
        visitor = _Imports()
        with open(path) as f:
            visitor.visit(ast.parse(f.read()))
        bad += [(path, name, line) for name, depth, line in visitor.found
                if name in FORBIDDEN or (name == "PIL" and depth == 0)]
    assert not bad, bad
