"""Attention over a sample whose mask drops every key, on the CPU in
float32: the port's plain forward and backward (the versions its kernels
are held against on the card) against the JAX package's attention with the
mask as an additive logit bias (``_mask_bias``, the form its training
graphs and the port's kernels take) under ``jax.vjp``, for multi-query and
multi-head attention, and against the fused Pallas ``mha_flash_bias`` in
interpret mode, whose backward renormalises each row
(``minimagen_tpu/ops/flash_attention.py:413-415``). A fully dropped row
attends uniformly, P = 1/j per key, on every side. (Autodiff through the
JAX package's where-mask form instead stops the gradient of masked logits,
so it gives such a row dq = 0; no training graph of either package takes
that form.) Tolerance 2e-5 of the largest value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.ops import attention as jattn
from minimagen_tpu.ops import flash_attention as jflash
from minimagen_tpu_torch.ops import attention as tattn
from minimagen_tpu_torch.ops import flash_attention as tflash


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(kind, b=3, h=2, n=24, j=21, d=64, seed=0):
    """Sample 1 drops every key; the others drop about a quarter."""
    rng = np.random.default_rng(seed)
    kv = (b, j, d) if kind == "mqa" else (b, h, j, d)
    q = (rng.normal(size=(b, h, n, d)) * d ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=kv).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    keep = rng.uniform(size=(b, j)) >= 0.25
    keep[:, 0] = True
    keep[1] = False
    return q, k, v, g, keep


def _close(ours, ref, rel=2e-5):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), f"max abs diff {err}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_plain_backward_of_dropped_rows_matches_jax_grad(kind):
    q, k, v, g, keep = _inputs(kind)
    jbias = jattn._mask_bias(jnp.asarray(keep), keep.shape[0], keep.shape[1])
    if kind == "mqa":
        jfn = lambda a, b, c: jattn.multi_query_attention(a, b, c, attn_bias=jbias)  # noqa: E731
    else:
        jfn = lambda a, b, c: jattn._mha_xla_attn(a, b, c, jbias)  # noqa: E731
    ref_out, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    bias = tattn.mask_bias(_t(keep))
    plain, plain_bwd = tflash._PLAIN[kind]
    out = plain(_t(q), _t(k), _t(v), attn_bias=bias)
    _close(out.numpy(), ref_out)
    # the dropped sample's rows average V (or each head's V) over all j keys
    mean_v = v[1].mean(axis=-2)
    _close(out[1].numpy(), np.broadcast_to(mean_v[None, None] if kind == "mqa"
                                           else mean_v[:, None], out[1].shape))
    for ours, ref in zip(plain_bwd(_t(q), _t(k), _t(v), _t(g), attn_bias=bias), refs):
        _close(ours.numpy(), ref)


def test_plain_backward_of_dropped_rows_matches_fused_pallas(monkeypatch):
    """The fused biased MHA backward in interpret mode renormalises P per
    row: its dq, dk, dv of a fully dropped sample equal the plain ones."""
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")
    q, k, v, g, keep = _inputs("mha", n=16, j=19, seed=1)
    bias = tattn.mask_bias(_t(keep))
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias.numpy()))
    ref_out, vjp = jax.vjp(jflash.mha_flash_bias, *args)
    refs = vjp(jnp.asarray(g))[:3]
    _close(tflash.mha_plain(_t(q), _t(k), _t(v), attn_bias=bias).numpy(), ref_out)
    for ours, ref in zip(tflash.mha_bwd_plain(_t(q), _t(k), _t(v), _t(g), attn_bias=bias), refs):
        _close(ours.numpy(), ref)
    # dv of the dropped sample: each key gets 1/j of the summed cotangent
    dv = tflash.mha_bwd_plain(_t(q), _t(k), _t(v), _t(g), attn_bias=bias)[2]
    _close(dv[1].numpy(), np.broadcast_to(g[1].sum(axis=1, keepdims=True) / 19, dv[1].shape))
