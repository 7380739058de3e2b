"""The ``Imagen`` options of the JAX package the port now takes, on the
CPU: ``remat`` recomputes the ResnetBlocks and TransformerBlocks in the
backward pass and gives the gradients of the plain run bit for bit;
``only_train_unet_number`` restricts ``forward``'s loss to one U-Net as the
JAX package's check does; ``state_dict`` / ``load_state_dict`` round-trip
every U-Net (the JAX package's shims) and refuse a wrong set of keys."""
import jax
import numpy as np
import pytest
import torch

from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu_torch.models import unet as T
from minimagen_tpu_torch.models.imagen import Imagen

KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
          layer_cross_attns=(False, True), attn_heads=2, attend_at_middle=True)
IMAGEN_KW = dict(image_sizes=(8, 16), timesteps=50, cond_drop_prob=0.1, text_encoder_name="t5_tiny")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cascade(**kw):
    torch.manual_seed(0)
    return Imagen([T.UnetConfig(**KW), T.UnetConfig(**KW)], device="cpu", **IMAGEN_KW, **kw)


def _losses(imagen, stage):
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    embeds = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    mask = torch.tensor([[True] * 5, [True, True, True, False, False]])
    gen = torch.Generator().manual_seed(2)
    return imagen.stage_loss(stage, images, embeds, mask, generator=gen)


@pytest.mark.parametrize("stage", [0, 1])
def test_remat_gives_the_same_gradients(stage):
    plain, remat = _cascade(), _cascade(remat=True)
    grads = []
    for imagen in (plain, remat):
        loss = _losses(imagen, stage)
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in imagen.unets[stage].parameters()]))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert all(a is not None and torch.equal(a, b) for a, b in zip(g0, g1))
    assert remat.unets[stage].remat and not plain.unets[stage].remat


def test_remat_recomputes_blocks_under_checkpoint(monkeypatch):
    """With remat, the backward runs each rematerialised block's forward a
    second time (the blocks the JAX U-Net wraps in nn.remat); sampling,
    without gradients, runs them once."""
    from minimagen_tpu_torch.models import layers

    calls = {"n": 0}
    real = layers.ResnetBlock.forward

    def counting(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(layers.ResnetBlock, "forward", counting)
    imagen = _cascade(remat=True)
    loss = _losses(imagen, 0)
    forward_calls = calls["n"]
    loss.backward()
    assert calls["n"] == 2 * forward_calls > 0
    calls["n"] = 0
    with torch.no_grad():
        _losses(imagen, 0)
    assert calls["n"] == forward_calls


def test_only_train_unet_number_matches_jax():
    ours = _cascade(only_train_unet_number=2)
    ref = JImagen(unets=[J.UnetConfig(**KW), J.UnetConfig(**KW)], only_train_unet_number=2,
                  **IMAGEN_KW)
    images = np.random.default_rng(3).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    embeds = np.zeros((2, 5, 64), np.float32)
    with pytest.raises(ValueError, match="only train on unet #2"):
        ours(images, text_embeds=torch.from_numpy(embeds), unet_number=1)
    with pytest.raises(AssertionError, match="only train on unet #2"):
        ref(images, text_embeds=embeds, unet_number=1, params={"unet_0": {}, "unet_1": {}},
            key=jax.random.PRNGKey(0))
    loss = ours(images, text_embeds=torch.from_numpy(embeds), unet_number=2,
                generator=torch.Generator().manual_seed(0))
    assert loss.ndim == 0 and torch.isfinite(loss)


def test_state_dict_round_trip():
    a, b = _cascade(), _cascade()
    torch.manual_seed(9)
    for p in b.unets.parameters():
        torch.nn.init.normal_(p)
    sd = a.state_dict()
    assert sorted(sd) == ["unet_0", "unet_1"]
    b.load_state_dict(sd)
    for ua, ub in zip(a.unets, b.unets):
        for (n, x), (_, y) in zip(ua.state_dict().items(), ub.state_dict().items()):
            assert torch.equal(x, y), n
    with pytest.raises(ValueError):
        b.load_state_dict({"unet_0": sd["unet_0"]})
