"""The port's ``training.make_optimizer`` against the JAX package's (optax:
clip_by_global_norm(50), then adam, optionally inside MultiSteps) on the
CPU: 5 steps on the same numpy gradients, for a float32 and a bfloat16
first moment, without and with accumulation over 3 mini-steps, with the
clip idle and active. Parameters must agree within 1e-6 relative per
element; a bfloat16 first moment bit for bit (the same float32 moment
rounded once), and so must the step counters. A port that rounded the
moment to bfloat16 before taking the update from it would miss the
parameters by ~1e-3 relative, which the last test shows."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import training as ttrain

SHAPES = [(40, 30), (7,), (3, 5, 2), (2, 3, 3, 4)]
LR = 1e-3
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(mu_name, accum, scale, seed=0, steps=STEPS, zero_start=False):
    rng = np.random.default_rng(seed)
    p0 = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    if zero_start:  # the parameters are then the updates, exactly
        p0 = [np.zeros_like(a) for a in p0]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    jtx = jmesh.make_optimizer(LR, accum, mu_dtype=jnp.bfloat16 if mu_name == "bf16" else None)
    jp = [jnp.asarray(a) for a in p0]
    js = jtx.init(jp)
    update = jax.jit(jtx.update)
    ttx = ttrain.make_optimizer(LR, accum, ttrain.MU_DTYPES[mu_name])
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    ts = ttx.init(tp)
    moved = []
    for g in grads:
        u, js = update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, u)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        moved.append(ttx.step(tp, ts))
    return p0, grads, jp, js, tp, ts, moved


def _adam_state(js, accum):
    return (js.inner_opt_state if accum > 1 else js)[1][0]


@pytest.mark.parametrize("scale", [0.02, 9.0], ids=["clip-idle", "clip-active"])
@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("mu_name", ["f32", "bf16"])
def test_optimizer_matches_optax(mu_name, accum, scale):
    p0, grads, jp, js, tp, ts, moved = _run(mu_name, accum, scale)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads[0]))
    assert (norm > ttrain.GRAD_CLIP_NORM) == (scale > 1.0)
    jadam = _adam_state(js, accum)
    assert ts.count == int(jadam.count) == STEPS // accum
    assert moved == [(i + 1) % accum == 0 for i in range(STEPS)]
    for a, b in zip(jp, tp):
        ref = np.asarray(a)
        rel = np.abs(b.detach().numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
        assert float(rel.max()) <= 1e-6
    for a, b in zip(jadam.mu, ts.mu):
        assert b.dtype == (torch.bfloat16 if mu_name == "bf16" else torch.float32)
        if mu_name == "bf16":  # the moment's bits
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          np.asarray(a).view(np.int16))
    if accum > 1:
        assert ts.mini_step == int(js.mini_step) == STEPS % accum
        assert ts.gradient_step == int(js.gradient_step)
        for a, b in zip(js.acc_grads, ts.acc_grads):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-12)


def test_mini_steps_leave_the_parameters_and_moments_alone():
    """Under accumulation the first accum - 1 calls move nothing but the
    running mean of the gradients (Welford's update, as MultiSteps)."""
    p0, grads, _, _, tp, ts, moved = _run("bf16", 3, 0.02, steps=2)
    assert moved == [False, False] and ts.count == 0
    for a, b in zip(p0, tp):
        np.testing.assert_array_equal(b.detach().numpy(), a)
    assert all(not m.any() for m in ts.mu)
    for i, acc in enumerate(ts.acc_grads):
        mean = grads[0][i] + (grads[1][i] - grads[0][i]) / np.float32(2)
        np.testing.assert_array_equal(acc.numpy(), mean)


def test_update_uses_the_moment_before_its_rounding():
    """The bfloat16 moment is stored rounded, but the update of its step
    comes from the float32 moment. From zero parameters (so they hold the
    update exactly) the port's first update equals optax's within 1e-6
    relative, while an update from the rounded moment lands more than 1e-4
    relative away."""
    _, grads, jp, _, tp, _, _ = _run("bf16", 1, 0.02, steps=1, zero_start=True)
    for a, b, gi in zip(jp, tp, grads[0]):
        mu = (np.float32(0.1) * gi).astype(ml_dtypes.bfloat16).astype(np.float32)
        nu = np.float32(0.001) * gi * gi
        rounded_first = -np.float32(LR) * ((mu / np.float32(0.1))
                                           / (np.sqrt(nu / np.float32(0.001)) + np.float32(1e-8)))
        ours, ref = b.detach().numpy(), np.asarray(a)
        scale = np.abs(ref).max()
        assert float(np.abs(ours - ref).max()) <= 1e-6 * scale
        assert float(np.abs(rounded_first - ref).max()) >= 1e-4 * scale


def test_none_gradients_count_as_zero():
    """A parameter without a gradient still takes Adam's step from zero, as
    optax updates every leaf."""
    ttx = ttrain.make_optimizer(LR)
    ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    st = ttx.init(ps)
    ps[0].grad = torch.full((3,), 0.5)
    ttx.step(ps, st)
    assert st.count == 1 and torch.equal(ps[1].detach(), torch.ones(2))
    assert not st.mu[1].any() and float(ps[0][0]) < 1.0


def test_global_norm_on_the_cpu_is_as_exact_as_optaxs_on_a_large_tensor():
    """The clip's norm over a 2^24-element gradient (the default cascade
    has 66M-element kernels) and two small ones, on the CPU: within 1e-6
    relative of the float64 norm, as optax's global_norm is. torch's own
    float32 CPU norm drifts low at this size, which put the CPU's clipped
    gradients of the default cascade off the card's by the clip factor."""
    rng = np.random.default_rng(21)
    grads = [(rng.standard_normal(1 << 24) * 1e-3).astype(np.float32),
             rng.standard_normal(7).astype(np.float32), rng.standard_normal((3, 5)).astype(np.float32)]
    want = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads)))
    ref = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    ours = float(ttrain.ClippedAdam.global_norm([torch.from_numpy(g) for g in grads]))
    assert abs(ref - want) <= 1e-6 * want
    assert abs(ours - want) <= 1e-6 * want
