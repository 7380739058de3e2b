"""The port's space-to-depth CrossEmbed stem (minimagen_tpu_torch/ops/stem_conv.py)
against the JAX package's (minimagen_tpu/ops/stem_conv.py) on the CPU in
float32, with numpy-seeded inputs: the weight algebra exactly, the
forward formulations, depth-to-space + bias (kernel 8's plain version)
against the Pallas kernel in interpret mode, and the stem's autograd
function (output, dx, dkernels, dbiases) against ``jax.grad`` through the
JAX package's custom VJP. Port kernels are OIHW, JAX's HWIO.

Tolerances: the weight maps move values and so agree exactly;
depth-to-space + bias is one add per element and agrees to the bit; a
convolution or its gradient sums up to 15*15*6 products (or b*H*W for a
weight gradient) in another order than XLA's, so it is held within 1e-5 of
the largest reference value (float32 rounding is ~1e-7 per add)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.ops import stem_conv as J
from minimagen_tpu_torch.ops import kernels
from minimagen_tpu_torch.ops import stem_conv as T

REL = 1e-5
SIZES = (3, 7, 15)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(cin, dim=32, seed=0):
    """HWIO kernels and biases of a stem of `dim` output channels split
    geometrically over the three scales, as CrossEmbedLayer splits them."""
    rng = np.random.default_rng(seed)
    dims = [dim // 2, dim // 4, dim - dim // 2 - dim // 4]
    ks = [(rng.normal(size=(k, k, cin, d)) / (k * np.sqrt(cin))).astype(np.float32)
          for k, d in zip(SIZES, dims)]
    bs = [rng.normal(size=(d,)).astype(np.float32) for d in dims]
    return ks, bs


def _oihw(ks):
    return [_t(k).permute(3, 2, 0, 1) for k in ks]


def _close(ours, ref):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= REL * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("cin", [3, 6])
@pytest.mark.parametrize("f", [2, 4])
def test_weight_algebra_matches_jax(f, cin):
    ks, _ = _weights(cin)
    jmerged = J.merge_cross_embed_kernels([jnp.asarray(k) for k in ks])
    tmerged = T.merge_cross_embed_kernels(_oihw(ks))
    np.testing.assert_array_equal(tmerged.permute(2, 3, 1, 0).numpy(), np.asarray(jmerged))
    assert T._s2d_kernel_size(15, f) == J._s2d_kernel_size(15, f)
    jw = J._space_to_depth_weight(jmerged, f)
    tw = T._space_to_depth_weight(tmerged, f)
    np.testing.assert_array_equal(tw.permute(2, 3, 1, 0).numpy(), np.asarray(jw))


@pytest.mark.parametrize("f", [2, 4])
def test_weight_gradient_map_is_the_transpose(f):
    """<s2d(w), g> = <w, s2d^T(g)> in float64: the stem backward's explicit
    gather-and-sum is the adjoint of the forward's kernel map."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(5, 3, 15, 15)))
    Kf = T._s2d_kernel_size(15, f)
    g = torch.from_numpy(rng.normal(size=(f * f * 5, f * f * 3, Kf, Kf)))
    lhs = float((T._space_to_depth_weight(w, f) * g).sum())
    rhs = float((w * T._space_to_depth_weight_grad(g, f, 15)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("f", [2, 4])
def test_space_to_depth_and_patches_match_jax(f):
    x = np.random.default_rng(1).normal(size=(2, 16, 12, 6)).astype(np.float32)
    s2d = T._space_to_depth(_t(x), f)
    np.testing.assert_array_equal(s2d.numpy(), np.asarray(J._space_to_depth(jnp.asarray(x), f)))
    np.testing.assert_array_equal(T._depth_to_space(s2d, f).numpy(), x)
    np.testing.assert_array_equal(T._s2d_patches(_t(x), 15).numpy(),
                                  np.asarray(J._s2d_patches(jnp.asarray(x), 15)))


@pytest.mark.parametrize("cin", [3, 6])
@pytest.mark.parametrize("f", [2, 4])
def test_s2d_conv_matches_jax(f, cin):
    ks, bs = _weights(cin)
    x = np.random.default_rng(2).normal(size=(2, 16, 16, cin)).astype(np.float32)
    ref = J.cross_embed_s2d_conv(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                                 [jnp.asarray(b) for b in bs], f, jnp.float32)
    _close(T.cross_embed_s2d_conv(_t(x), _oihw(ks), [_t(b) for b in bs], f), ref)


def test_fused_matches_jax():
    ks, bs = _weights(6)
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 6)).astype(np.float32)
    ref = J.cross_embed_fused(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                              [jnp.asarray(b) for b in bs], jnp.float32)
    _close(T.cross_embed_fused(_t(x), _oihw(ks), [_t(b) for b in bs]), ref)


@pytest.mark.parametrize("f", [2, 4])
def test_depth_to_space_bias_matches_pallas_interpret(f, monkeypatch):
    """The port's depth_to_space_bias on the CPU (its plain version, no
    launch) against the Pallas kernel in interpret mode: equal bits."""
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    c = 16
    y2 = rng.normal(size=(2, 8, 8, f * f * c)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    ref = np.asarray(J._depth_to_space_bias_pallas(jnp.asarray(y2), jnp.asarray(bias), f))
    kernels.reset_launch_counts()
    out = T.depth_to_space_bias(_t(y2), _t(bias), f)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert kernels.LAUNCHES["depth_to_space_bias"] == 0


def _jax_stem(x, ks, bs, g):
    """Output and (dx, dkernels, dbiases) of sum(stem * g) through the JAX
    package's custom-VJP stem (its s2d-4 forward where H, W divide by 4)."""
    stem = J._stem_vjp_fns(jnp.float32)
    args = (jnp.asarray(x), [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs])
    out = stem(*args)
    grads = jax.grad(lambda *a: jnp.sum(stem(*a) * jnp.asarray(g)), argnums=(0, 1, 2))(*args)
    return out, grads


@pytest.mark.parametrize("cin,size", [(3, 16), (6, 16), (3, 18)],
                         ids=["cin3-s2d4", "cin6-s2d4", "cin3-size18-reference"])
def test_stem_function_matches_jax_grad(cin, size):
    """Forward and all three gradients; at 18 px (even, not divisible by 4)
    both packages run the reference forward and the s2d-2 weight gradient."""
    ks, bs = _weights(cin)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    g = rng.normal(size=(2, size, size, 32)).astype(np.float32)
    ref, (jdx, jdk, jdb) = _jax_stem(x, ks, bs, g)
    tx = _t(x).requires_grad_()
    tk = [k.clone().requires_grad_() for k in _oihw(ks)]
    tb = [_t(b).requires_grad_() for b in bs]
    out = T.cross_embed_conv(tx, tk, tb, stride=1)
    assert type(out.grad_fn).__name__ == "StemConvBackward"
    (out * _t(g)).sum().backward()
    _close(out, ref)
    _close(tx.grad, jdx)
    for ours, want in zip(tk, jdk):
        _close(ours.grad.permute(2, 3, 1, 0), want)
    for ours, want in zip(tb, jdb):
        _close(ours.grad, want)


def test_stem_skips_dx_for_data_inputs():
    """With an input that needs no gradient (the U-Net's case) the weight
    and bias gradients are the same as with one that does."""
    ks, bs = _weights(3)
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
    g = _t(rng.normal(size=(2, 16, 16, 32)).astype(np.float32))
    grads = []
    for x_grad in (False, True):
        tk = [k.clone().requires_grad_() for k in _oihw(ks)]
        tb = [_t(b).requires_grad_() for b in bs]
        xi = x.clone().requires_grad_(x_grad)
        grads.append(torch.autograd.grad((T.cross_embed_conv(xi, tk, tb, stride=1) * g).sum(),
                                         tk + tb))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size,stride,sizes", [(15, 1, SIZES), (16, 2, (2, 4))],
                         ids=["odd-size", "stride2"])
def test_odd_size_and_stride_two_take_the_reference(size, stride, sizes):
    rng = np.random.default_rng(6)
    ws = [_t(rng.normal(size=(8, 3, k, k)).astype(np.float32)) for k in sizes]
    bs = [_t(rng.normal(size=(8,)).astype(np.float32)) for _ in sizes]
    x = _t(rng.normal(size=(2, size, size, 3)).astype(np.float32))
    ref = T.cross_embed_reference(x, ws, bs, stride)
    assert torch.equal(T.cross_embed_conv(x, ws, bs, stride=stride), ref)
    ws = [w.clone().requires_grad_() for w in ws]
    out = T.cross_embed_conv(x, ws, bs, stride=stride)
    assert type(out.grad_fn).__name__ != "StemConvBackward"
    jref = J.cross_embed_conv(jnp.asarray(x.numpy()), [jnp.asarray(w.detach().permute(2, 3, 1, 0).numpy())
                                                       for w in ws],
                              [jnp.asarray(b.numpy()) for b in bs], stride=stride, dtype=jnp.float32)
    _close(out, jref)
