"""The port's ops (minimagen_tpu_torch/ops) against their JAX counterparts on
the CPU, in float32, on the same numpy inputs. The JAX side runs its Pallas
kernels in interpret mode, as the JAX package's own tests do."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.ops import attention as jattn
from minimagen_tpu.ops import diffusion as jdiff
from minimagen_tpu.ops import group_norm as jgn
from minimagen_tpu.ops import helpers as jhelpers
from minimagen_tpu.ops.resize import resize_image_to as j_resize
from minimagen_tpu.ops.stem_conv import cross_embed_reference as j_stem
from minimagen_tpu_torch.ops import attention as tattn
from minimagen_tpu_torch.ops import diffusion as tdiff
from minimagen_tpu_torch.ops import group_norm as tgn
from minimagen_tpu_torch.ops import helpers as thelpers
from minimagen_tpu_torch.ops.resize import resize_image_to as t_resize
from minimagen_tpu_torch.ops.stem_conv import cross_embed_reference as t_stem


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# --------------------------------------------------------------------------- #
# helpers and diffusion                                                       #
# --------------------------------------------------------------------------- #
def test_helpers_match_jax():
    rng = _rng()
    a = rng.normal(size=(50,)).astype(np.float32)
    t = np.array([0, 7, 49], np.int32)
    np.testing.assert_array_equal(thelpers.extract(_t(a), _t(t), 4).numpy(),
                                  np.asarray(jhelpers.extract(jnp.asarray(a), jnp.asarray(t), 4)))
    x = rng.uniform(size=(2, 3, 4, 5)).astype(np.float32)
    s = rng.uniform(size=(2,)).astype(np.float32)
    assert thelpers.right_pad_dims_to(_t(x), _t(s)).shape == (2, 1, 1, 1)
    np.testing.assert_array_equal(thelpers.normalize_neg_one_to_one(_t(x)).numpy(),
                                  np.asarray(jhelpers.normalize_neg_one_to_one(jnp.asarray(x))))
    np.testing.assert_array_equal(thelpers.unnormalize_zero_to_one(_t(x)).numpy(),
                                  np.asarray(jhelpers.unnormalize_zero_to_one(jnp.asarray(x))))


def test_prob_mask_like_edge_probs_and_generator():
    assert thelpers.prob_mask_like((3,), 1.0, device="cpu").all()
    assert not thelpers.prob_mask_like((3,), 0.0, device="cpu").any()
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    m1 = thelpers.prob_mask_like((1000,), 0.3, generator=g1, device="cpu")
    m2 = thelpers.prob_mask_like((1000,), 0.3, generator=g2, device="cpu")
    assert torch.equal(m1, m2) and 0.2 < m1.float().mean() < 0.4


def test_abs_quantile_bisect_matches_jax():
    x = _rng(1).normal(size=(2, 2 ** 17)).astype(np.float32) * 2.0
    ours = thelpers.abs_quantile_bisect(_t(x), 0.9).numpy()
    ref = np.asarray(jhelpers.abs_quantile_bisect(jnp.asarray(x), 0.9))
    assert _max_abs(ours, ref) <= 1e-6


@pytest.mark.parametrize("timesteps", [20, 100, 1000])
def test_schedule_buffers_bit_equal(timesteps):
    ours = tdiff.GaussianDiffusion(timesteps, device="cpu")
    ref = jdiff.create_gaussian_diffusion(timesteps)
    for name in tdiff._BUFFERS:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_diffusion_closed_forms_match_jax():
    rng = _rng(2)
    ours, ref = tdiff.GaussianDiffusion(100, device="cpu"), jdiff.create_gaussian_diffusion(100)
    x0 = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    xt = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    eps = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 37, 99])
    tp = np.array([-1, 20, 80])
    jt, jtp = jnp.asarray(t, jnp.int32), jnp.asarray(tp, jnp.int32)
    pairs = [
        (ours.q_sample(_t(x0), _t(t), _t(eps)), ref.q_sample(jnp.asarray(x0), jt, jnp.asarray(eps))),
        (ours.predict_start_from_noise(_t(xt), _t(t), _t(eps)),
         ref.predict_start_from_noise(jnp.asarray(xt), jt, jnp.asarray(eps))),
        (ours.ddim_step(_t(xt), _t(x0), _t(t), _t(tp)),
         ref.ddim_step(jnp.asarray(xt), jnp.asarray(x0), jt, jtp)),
    ]
    for a, b in zip(ours.q_posterior(_t(x0), _t(xt), _t(t)),
                    ref.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jt)):
        pairs.append((a, b))
    for a, b in pairs:
        assert _max_abs(a.numpy(), b) <= 1e-5


@pytest.mark.parametrize("steps", [1, 3, 50, 1000])
def test_strided_timesteps_equal(steps):
    ours = tdiff.GaussianDiffusion(1000, device="cpu").strided_sampling_timesteps(steps)
    ref = jdiff.create_gaussian_diffusion(1000).strided_sampling_timesteps(steps, "time")
    np.testing.assert_array_equal(ours, ref)


def test_get_times_matches_jax():
    ours = tdiff.GaussianDiffusion(1000, device="cpu").get_times(4, 0.2, device="cpu")
    ref = jdiff.create_gaussian_diffusion(1000).get_times(4, 0.2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------- #
# resize and stem                                                             #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("src,dst", [(16, 64), (64, 16), (8, 32), (32, 32)])
def test_resize_image_to_matches_jax(src, dst):
    x = _rng(3).uniform(size=(2, src, src, 3)).astype(np.float32)
    ours = t_resize(_t(x), dst).numpy()
    ref = np.asarray(j_resize(jnp.asarray(x), dst))
    assert ours.shape == ref.shape == (2, dst, dst, 3)
    assert _max_abs(ours, ref) <= 1e-5


def test_cross_embed_reference_matches_jax():
    rng = _rng(4)
    x = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    ks = [rng.normal(size=(k, k, 6, c)).astype(np.float32) * 0.1
          for k, c in ((3, 8), (7, 4), (15, 4))]
    bs = [rng.normal(size=(c,)).astype(np.float32) for c in (8, 4, 4)]
    ref = np.asarray(j_stem(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                            [jnp.asarray(b) for b in bs], 1, jnp.float32))
    ours = t_stem(_t(x), [_t(k).permute(3, 2, 0, 1) for k in ks], [_t(b) for b in bs], 1)
    assert ours.shape == ref.shape
    assert _max_abs(ours.numpy(), ref) <= 1e-4


# --------------------------------------------------------------------------- #
# attention (plain versions of kernels 1-2)                                   #
# --------------------------------------------------------------------------- #
def _qkv(b, h, n, j, d, per_head, seed=5):
    rng = _rng(seed)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32) * d ** -0.5
    kv_shape = (b, h, j, d) if per_head else (b, j, d)
    return q, rng.normal(size=kv_shape).astype(np.float32), rng.normal(size=kv_shape).astype(np.float32)


@pytest.mark.parametrize("n,j", [(64, 65), (16, 259), (512, 513)])
def test_multi_query_attention_matches_jax(n, j):
    q, k, v = _qkv(2, 2, n, j, 64, per_head=False)
    ours = tattn.multi_query_attention(_t(q), _t(k), _t(v)).numpy()
    ref = np.asarray(jattn.multi_query_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert _max_abs(ours, ref) <= 1e-5


@pytest.mark.parametrize("n,j", [(64, 19), (64, 21), (16, 259), (512, 261)])
def test_multi_head_attention_matches_jax(n, j):
    q, k, v = _qkv(2, 2, n, j, 64, per_head=True)
    ours = tattn.multi_head_attention(_t(q), _t(k), _t(v)).numpy()
    ref = np.asarray(jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert _max_abs(ours, ref) <= 1e-5


def test_masked_and_biased_attention_match_jax():
    q, k, v = _qkv(2, 2, 8, 11, 64, per_head=False)
    mask = _rng(6).uniform(size=(2, 11)) < 0.7
    mask[:, 0] = True
    bias = _rng(7).normal(size=(2, 1, 1, 11)).astype(np.float32)
    ours = tattn.multi_query_attention(_t(q), _t(k), _t(v), mask=_t(mask), attn_bias=_t(bias))
    ref = jattn.multi_query_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      mask=jnp.asarray(mask), attn_bias=jnp.asarray(bias))
    assert _max_abs(ours.numpy(), ref) <= 1e-5
    q, k, v = _qkv(2, 2, 8, 11, 64, per_head=True)
    ours = tattn.multi_head_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    ref = jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     mask=jnp.asarray(mask))
    assert _max_abs(ours.numpy(), ref) <= 1e-5


# --------------------------------------------------------------------------- #
# GroupNorm (plain version of kernel 3)                                       #
# --------------------------------------------------------------------------- #
def _gn_inputs(b, h, w, c, seed=8):
    rng = _rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 3.0 + 0.5).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    ss = tuple((rng.normal(size=(b, 1, 1, c)) * 0.3).astype(np.float32) for _ in range(2))
    return x, gamma, beta, ss


@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("silu,with_ss", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((1, 4, 4, 64), 8)])
def test_group_norm_silu_matches_jax(monkeypatch, pallas, silu, with_ss, shape, groups):
    """Against the interpreted Pallas kernel and against the XLA path."""
    if not pallas:
        monkeypatch.delenv("MINIMAGEN_TPU_PALLAS_INTERPRET")
    x, gamma, beta, ss = _gn_inputs(*shape)
    jss = tuple(jnp.asarray(s) for s in ss) if with_ss else None
    ref = jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                              groups=groups, scale_shift=jss, silu=silu)
    tss = tuple(_t(s) for s in ss) if with_ss else None
    ours = tgn.group_norm_silu(_t(x), _t(gamma), _t(beta), groups=groups, scale_shift=tss,
                               silu=silu)
    assert _max_abs(ours.numpy(), ref) <= 1e-5


def test_group_norm_plain_keeps_bf16_cast_order():
    """In bf16 the normalised value is rounded before gamma/beta, as the
    JAX package's XLA path does: the plain version equals that sequence of
    roundings exactly."""
    x, gamma, beta, ss = _gn_inputs(2, 4, 4, 16)
    xb = _t(x).bfloat16()
    out = tgn.group_norm_silu_plain(xb, _t(gamma), _t(beta), groups=8,
                                    scale_shift=tuple(_t(s).bfloat16() for s in ss), silu=True)
    assert out.dtype == torch.bfloat16
    xg = xb.float().reshape(2, 4, 4, 8, 2)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    n = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(2, 4, 4, 16).bfloat16()
    n = n * _t(gamma).bfloat16() + _t(beta).bfloat16()
    n = n * (_t(ss[0]).bfloat16() + 1.0) + _t(ss[1]).bfloat16()
    assert torch.equal(out, torch.nn.functional.silu(n))
