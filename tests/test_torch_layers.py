"""Each layer module of the port (minimagen_tpu_torch/models/layers.py)
against its flax counterpart on the CPU in float32: the flax module is
initialised from a seed, its parameter tree is carried over with the port's
checkpoint mapping (which must match every key), and both run on the same
numpy inputs. Max-abs tolerance 1e-4. The JAX GroupNorm runs its Pallas
kernel in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.models import layers as J
from minimagen_tpu_torch.checkpoint import unet_state_dict
from minimagen_tpu_torch.models import layers as T

TOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _check(jmod, tmod, args, kwargs=None):
    """Init `jmod` on `args`, load its params into `tmod`, compare outputs."""
    kwargs = kwargs or {}
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kwargs.items()}
    variables = jmod.init(jax.random.PRNGKey(0), *jargs, **jkw)
    ref = np.asarray(jmod.apply(variables, *jargs, **jkw))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmod.load_state_dict(unet_state_dict(params), strict=True)
    to_t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    with torch.no_grad():
        out = tmod(*[to_t(a) for a in args], **{k: to_t(v) for k, v in kwargs.items()}).numpy()
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= TOL, f"max abs diff {err}"


def test_layer_norms():
    x = _arr((2, 5, 16), 0, 3.0) + 2.0
    _check(J.LayerNorm(16), T.LayerNorm(16), [x])
    _check(J.ChanLayerNorm(16), T.ChanLayerNorm(16), [x])
    _check(J.AffineLayerNorm(16), T.AffineLayerNorm(16), [x])


@pytest.mark.parametrize("silu,with_ss", [(True, True), (False, False)])
def test_group_norm(silu, with_ss):
    x = _arr((2, 8, 8, 32), 1, 2.0)
    ss = (_arr((2, 1, 1, 32), 2, 0.3), _arr((2, 1, 1, 32), 3, 0.3)) if with_ss else None
    jss = tuple(jnp.asarray(s) for s in ss) if with_ss else None
    jmod = J.GroupNorm(8, 32)
    variables = {"params": {"scale": jnp.asarray(_arr((32,), 4, 0.2) + 1.0),
                            "bias": jnp.asarray(_arr((32,), 5, 0.1))}}
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), scale_shift=jss, silu=silu))
    tmod = T.GroupNorm(8, 32)
    tmod.load_state_dict(unet_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"])))
    tss = tuple(torch.from_numpy(s) for s in ss) if with_ss else None
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), scale_shift=tss, silu=silu).numpy()
    assert float(np.abs(out - ref).max()) <= TOL


def test_sinusoidal_pos_emb():
    t = np.array([0, 1, 17, 999], np.int32)
    ref = np.asarray(J.sinusoidal_pos_emb(jnp.asarray(t), 32))
    out = T.sinusoidal_pos_emb(torch.from_numpy(t), 32).numpy()
    assert float(np.abs(out - ref).max()) <= TOL


def test_attention_self():
    x = _arr((2, 16, 32), 6)
    _check(J.Attention(dim=32, heads=2), T.Attention(32, heads=2), [x])


def test_attention_with_context_and_mask():
    x, ctx = _arr((2, 16, 32), 7), _arr((2, 5, 24), 8)
    # a (b, j') mask covers the last j' keys; the module pads the rest True
    mask = np.ones((2, 5), bool)
    mask[1, 3:] = False
    _check(J.Attention(dim=32, heads=2, context_dim=24), T.Attention(32, heads=2, context_dim=24),
           [x], dict(context=ctx, mask=mask))


@pytest.mark.parametrize("norm_context,masked", [(False, False), (True, True)])
def test_cross_attention(norm_context, masked):
    x, ctx = _arr((2, 16, 32), 9), _arr((2, 7, 24), 10)
    kwargs = {}
    if masked:
        mask = np.ones((2, 7), bool)
        mask[0, 4:] = False
        kwargs["mask"] = mask
    _check(J.CrossAttention(dim=32, context_dim=24, heads=2, norm_context=norm_context),
           T.CrossAttention(32, context_dim=24, heads=2, norm_context=norm_context),
           [x, ctx], kwargs)


@pytest.mark.parametrize("norm", [True, False])
def test_block(norm):
    x = _arr((2, 8, 8, 16), 11)
    ss = (_arr((2, 1, 1, 16), 12, 0.3), _arr((2, 1, 1, 16), 13, 0.3))
    jmod = J.Block(16, 24, groups=8, norm=norm)
    jss = tuple(jnp.asarray(s) for s in ss)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), scale_shift=jss)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), scale_shift=jss))
    tmod = T.Block(16, 24, groups=8, norm=norm)
    tmod.load_state_dict(unet_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"])),
                         strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), scale_shift=tuple(torch.from_numpy(s) for s in ss)).numpy()
    assert float(np.abs(out - ref).max()) <= TOL


@pytest.mark.parametrize("dim,dim_out,cond", [(16, 16, False), (16, 32, True)])
def test_resnet_block(dim, dim_out, cond):
    x, t = _arr((2, 8, 8, dim), 14), _arr((2, 64), 15)
    c = _arr((2, 6, 16), 16) if cond else None
    _check(J.ResnetBlock(dim, dim_out, cond_dim=16 if cond else None, time_cond_dim=64),
           T.ResnetBlock(dim, dim_out, cond_dim=16 if cond else None, time_cond_dim=64),
           [x, t, c])


def test_chan_feed_forward_and_transformer_block():
    x = _arr((2, 4, 4, 32), 17)
    _check(J.ChanFeedForward(32, mult=2), T.ChanFeedForward(32, mult=2), [x])
    _check(J.TransformerBlock(32, heads=2, dim_head=64), T.TransformerBlock(32, heads=2, dim_head=64),
           [x])


def test_cross_embed_layer():
    x = _arr((2, 16, 16, 6), 18)
    _check(J.CrossEmbedLayer(dim_in=6, kernel_sizes=(3, 7, 15), dim_out=16, stride=1),
           T.CrossEmbedLayer(6, (3, 7, 15), dim_out=16, stride=1), [x])


def test_resampling_layers():
    x = _arr((2, 8, 8, 16), 19)
    _check(J.Downsample(24), T.Downsample(16, 24), [x])
    _check(J.Upsample(24), T.Upsample(16, 24), [x])
    _check(J.ParallelSum(24), T.ParallelSum(16, 24), [x])
