"""The port's training ops against the JAX package on the CPU in float32:
the plain attention and GroupNorm backwards (and the biased MHA forward)
against ``jax.vjp`` of the JAX package's ``custom_vjp``s, which run their
Pallas kernels in interpret mode; and ``torch.autograd.gradcheck`` in
float64 of the port's three ``autograd.Function``s on the CPU path. Inputs
are numpy arrays from a seed. Tolerances: 2e-5 of the largest value for
the attention gradients and 1e-4 for GroupNorm's (float32 sums over up to
b*h*w elements in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.ops import flash_attention as jflash
from minimagen_tpu.ops import group_norm as jgn
from minimagen_tpu_torch.ops import attention as tattn
from minimagen_tpu_torch.ops import flash_attention as tflash
from minimagen_tpu_torch.ops import group_norm as tgn


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MINIMAGEN_TPU_FUSED_BWD_THRESHOLD", "0")  # always the fused backward


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), f"max abs diff {err}"


def _attention_inputs(kind, b, h, n, j, d=64, seed=0):
    rng = np.random.default_rng(seed)
    kv = (b, j, d) if kind == "mqa" else (b, h, j, d)
    q = (rng.normal(size=(b, h, n, d)) * d ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=kv).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    keep = rng.uniform(size=(b, j)) >= 0.25
    keep[:, 0] = True
    return q, k, v, g, keep


# n = 24 and 40 give the Pallas kernels 3 and 5 q-blocks of 8; j is ragged
@pytest.mark.parametrize("n,j", [(24, 25), (40, 19), (64, 65)])
def test_mqa_bwd_plain_matches_jax_vjp(n, j):
    q, k, v, g, _ = _attention_inputs("mqa", 2, 2, n, j)
    ref_out, vjp = jax.vjp(jflash.mqa_flash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    ours = tflash.mqa_bwd_plain(_t(q), _t(k), _t(v), _t(g))
    _close(tflash.mqa_plain(_t(q), _t(k), _t(v)).numpy(), ref_out, 2e-5)
    for a, r in zip(ours, refs):
        _close(a.numpy(), r, 2e-5)


@pytest.mark.parametrize("n,j", [(24, 21), (40, 67), (16, 259)])
def test_mha_bias_plain_fwd_bwd_match_jax_vjp(n, j):
    """The biased MHA forward and backward (kernels 6 and 7) against
    ``mha_flash_bias``, with a bias from a mask dropping ~1/4 of the keys;
    the bias cotangent is zero on both sides."""
    q, k, v, g, keep = _attention_inputs("mha", 2, 2, n, j, seed=1)
    bias = tattn.mask_bias(_t(keep)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    ref_out, vjp = jax.vjp(jflash.mha_flash_bias, *args)
    rdq, rdk, rdv, rdb = vjp(jnp.asarray(g))
    assert not np.asarray(rdb).any()
    _close(tflash.mha_plain(_t(q), _t(k), _t(v), attn_bias=_t(bias)).numpy(), ref_out, 2e-5)
    ours = tflash.mha_bwd_plain(_t(q), _t(k), _t(v), _t(g), attn_bias=_t(bias))
    for a, r in zip(ours, (rdq, rdk, rdv)):
        _close(a.numpy(), r, 2e-5)


def test_masked_attention_bias_matches_where_mask():
    """The additive mask bias gives the where-masked softmax bit for bit."""
    q, k, v, _, keep = _attention_inputs("mha", 2, 2, 8, 13, seed=2)
    where = tflash.mha_plain(_t(q), _t(k), _t(v), mask=_t(keep))
    added = tflash.mha_plain(_t(q), _t(k), _t(v), attn_bias=tattn.mask_bias(_t(keep)))
    assert torch.equal(where, added)


@pytest.mark.parametrize("silu,with_ss", [(True, True), (True, False), (False, True),
                                          (False, False)])
@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 32), 8), ((3, 5, 3, 16), 4)])
def test_group_norm_bwd_plain_matches_jax_vjp(silu, with_ss, shape, groups):
    rng = np.random.default_rng(3)
    b, h, w, c = shape
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    ss = [(0.3 * rng.normal(size=(b, c))).astype(np.float32) if with_ss
          else np.zeros((b, c), np.float32) for _ in range(2)]
    g = rng.normal(size=shape).astype(np.float32)
    fn = lambda *a: jgn._fused(groups, 1e-5, silu, *a)  # noqa: E731
    ref_y, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, gamma, beta, *ss)))
    rdx, rdgamma, rdbeta, rds, rdt = vjp(jnp.asarray(g))

    scale, shift = (_t(s[:, None, None, :]) if with_ss else None for s in ss)
    mean, rstd = tgn.group_stats_plain(_t(x), groups)
    ss_pair = None if scale is None else (scale, shift)
    y = tgn.group_norm_silu_plain(_t(x), _t(gamma), _t(beta), groups=groups, scale_shift=ss_pair,
                                  silu=silu)
    _close(y.numpy(), ref_y, 1e-5)
    dx, dgamma, dbeta, ds, dt = tgn.group_norm_silu_bwd_plain(
        _t(x), _t(gamma), _t(beta), scale, shift, mean, rstd, _t(g), groups=groups, silu=silu)
    for a, r in [(dx, rdx), (dgamma, rdgamma), (dbeta, rdbeta)] + (
            [(ds, rds), (dt, rdt)] if with_ss else []):
        _close(a.numpy(), r, 1e-4)
    if not with_ss:
        assert ds is None and dt is None


# --------------------------------------------------------------------------- #
# gradcheck of the autograd.Functions on the CPU path                         #
# --------------------------------------------------------------------------- #
def _f64(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.float64)).requires_grad_() for a in arrays)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_functions_gradcheck(with_bias):
    q, k, v, _, keep = _attention_inputs("mha", 2, 2, 5, 7, d=8, seed=4)
    bias = tattn.mask_bias(_t(keep)) if with_bias else None
    assert torch.autograd.gradcheck(lambda *a: tflash.MHAFlash.apply(*a, bias), _f64(q, k, v))
    q, k, v, _, _ = _attention_inputs("mqa", 2, 2, 5, 7, d=8, seed=5)
    assert torch.autograd.gradcheck(lambda *a: tflash.MQAFlash.apply(*a, bias), _f64(q, k, v))


@pytest.mark.parametrize("silu,with_ss", [(True, True), (False, True), (True, False)])
def test_group_norm_function_gradcheck(silu, with_ss):
    rng = np.random.default_rng(6)
    b, h, w, c, groups = 2, 3, 2, 8, 4
    arrays = [rng.normal(size=(b, h, w, c)), 1.0 + 0.2 * rng.normal(size=c),
              0.1 * rng.normal(size=c)]
    if with_ss:
        arrays += [0.3 * rng.normal(size=(b, 1, 1, c)) for _ in range(2)]

    def fn(x, gamma, beta, *ss):
        return tgn.GroupNormSiLU.apply(x, gamma, beta, *(ss or (None, None)), groups, 1e-5, silu)

    assert torch.autograd.gradcheck(fn, _f64(*arrays))


def test_wrappers_build_autograd_graph_only_for_gradients():
    """Without a gradient wanted the wrappers return the plain forward as
    before; with one, the autograd.Functions, whose gradients agree with
    autograd through the plain version."""
    q, k, v, g, _ = _attention_inputs("mqa", 1, 2, 8, 9, seed=7)
    tq, tk, tv = _t(q), _t(k).requires_grad_(), _t(v)
    out = tflash.mqa_flash(tq, tk, tv)
    assert out.grad_fn.name() == "MQAFlashBackward"
    (dk,) = torch.autograd.grad(out, tk, _t(g))
    (ref_dk,) = torch.autograd.grad(tflash.mqa_plain(tq, tk, tv), tk, _t(g))
    _close(dk.numpy(), ref_dk.numpy(), 1e-5)
    with torch.no_grad():
        assert torch.equal(tflash.mqa_flash(tq, tk, tv), tflash.mqa_plain(tq, tk, tv))
