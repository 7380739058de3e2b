"""The port's U-Net against the JAX UnetModel on the CPU in float32, at the
same weights (the flax parameter tree carried over by the port's checkpoint
mapping) and the same numpy inputs, for the base topology and the
super-resolution / memory_efficient one. Relative tolerance 1e-3 of the
largest output. The JAX side runs its Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.models import unet as J
from minimagen_tpu_torch.checkpoint import unet_state_dict
from minimagen_tpu_torch.models import unet as T

BASE_KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
               layer_cross_attns=(False, True), attn_heads=2, attend_at_middle=True,
               text_embed_dim=64)
SR_KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 2), layer_attns=(False, True),
             layer_cross_attns=(False, True), attn_heads=2, lowres_cond=True,
             memory_efficient=True, text_embed_dim=64)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")


def _inputs(size, lowres, seed=0, b=2, text_len=5):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, text_len), bool)
    mask[1, 3:] = False
    inp = dict(
        x=rng.normal(size=(b, size, size, 3)).astype(np.float32),
        time=np.array([3, 871], np.int32)[:b],
        text_embeds=rng.normal(size=(b, text_len, 64)).astype(np.float32),
        text_mask=mask,
        text_keep_mask=np.array([True, False])[:b],
    )
    if lowres:
        inp["lowres_cond_img"] = rng.normal(size=(b, size, size, 3)).astype(np.float32)
        inp["lowres_noise_times"] = np.array([200, 200], np.int32)[:b]
    return inp


@pytest.mark.parametrize("kw,size", [(BASE_KW, 16), (SR_KW, 32)], ids=["base", "sr_memory_efficient"])
def test_unet_forward_matches_jax(kw, size):
    inp = _inputs(size, kw.get("lowres_cond", False))
    jmodel = J.UnetModel(config=J.UnetConfig(**kw))
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    x, time = jin.pop("x"), jin.pop("time")
    variables = jmodel.init(jax.random.PRNGKey(0), x, time, **jin)
    ref = np.asarray(jmodel.apply(variables, x, time, **jin))

    tmodel = T.UnetModel(T.UnetConfig(**kw))
    tmodel.load_state_dict(unet_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"])),
                           strict=True)
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        out = tmodel(tin.pop("x"), tin.pop("time"), **tin).numpy()
    assert out.shape == ref.shape == (2, size, size, 3) and out.dtype == np.float32
    assert float(np.abs(out - ref).max()) <= 1e-3 * float(np.abs(ref).max())


def test_unet_config_matches_jax():
    for kw in (BASE_KW, SR_KW):
        assert T.UnetConfig(**kw).to_dict() == J.UnetConfig(**kw).to_dict()
        assert T.UnetConfig(**kw).layer_params() == J.UnetConfig(**kw).layer_params()
    for name in ("Base", "Super", "BaseTest", "SuperTest"):
        ours, ref = getattr(T, name)(), getattr(J, name)()
        assert ours.to_dict() == ref.to_dict() and ours.defaults == ref.defaults
    cfg = T.UnetConfig.from_dict(T.UnetConfig(**SR_KW).to_dict())
    assert cfg == T.UnetConfig(**SR_KW)
    cast = cfg.cast_model_parameters(lowres_cond=False, text_embed_dim=32, channels=3,
                                     channels_out=3)
    assert cast.to_dict() == J.UnetConfig(**SR_KW).cast_model_parameters(
        lowres_cond=False, text_embed_dim=32, channels=3, channels_out=3).to_dict()
    assert cast.time_cond_dim == 64


def test_unet_bf16_forward_runs_in_bf16():
    """A model built in bfloat16 holds bf16 weights, computes in bf16 and
    returns float32, as the JAX model with dtype=bfloat16 does."""
    model = T.UnetModel(T.UnetConfig(**BASE_KW), dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    inp = {k: torch.from_numpy(v) for k, v in _inputs(16, False).items()}
    with torch.no_grad():
        out = model(inp.pop("x"), inp.pop("time"), **inp)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
