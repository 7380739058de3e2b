"""The reference's default cascade in the port against the JAX package on the
CPU: the offline hash text encoder (bit-equal), the parameters of the
committed ``parameters/`` directory and of the presets, the cascade that
``default_imagen`` builds from them, and narrow versions of the ``Base``
and ``Super`` topologies (dim 16, every other setting the preset's) in
float32: a guided forward and a ``stage_loss`` gradient with the weights
carried across and every draw injected. The JAX side takes its own
space-to-depth stem (``MINIMAGEN_TPU_STEM_FUSED=1``), as the port does on
every device.

Tolerances: the guided forward within 1e-4 of its largest value and the
loss within 1e-5 relative (float32 sums in other orders through ~60
layers); each parameter gradient with a norm above 1e-3 of the largest
within 1e-4 relative L2 (the limit of ``test_torch_training.py``)."""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu import training as jtrain
from minimagen_tpu.models import t5 as Jt5
from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.checkpoint import unet_state_dict
from minimagen_tpu_torch.generate import default_imagen
from minimagen_tpu_torch.models import t5 as Tt5
from minimagen_tpu_torch.models import unet as T
from minimagen_tpu_torch.models.imagen import Imagen as TImagen
from test_torch_training import _flax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS_DIR = os.path.join(REPO, "parameters")
WORDS = ("a small red square on a blue field with two green circles and one tall yellow "
         "triangle under a grey sky").split()
CAPTIONS = ["", *(" ".join(WORDS[:n]) for n in (1, 2, 5, 9, 16, 20)), "A Red  SQUARE"]
SIZES = (16, 32)
B = 2


@pytest.mark.parametrize("name", ["t5_small", "t5_base"])
def test_hash_encoder_matches_jax(name):
    """Captions of 0-20 words, truncated at 8 or not: the same bits, also
    through the port's TextEncoder."""
    for max_length in (8, 256):
        ref, ref_mask = Jt5._fallback_encode(CAPTIONS, name, max_length)
        enc, mask = Tt5._fallback_encode(CAPTIONS, name, max_length)
        np.testing.assert_array_equal(enc, ref)
        np.testing.assert_array_equal(mask, ref_mask)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        enc, mask = Tt5.TextEncoder(name, device="cpu").encode(CAPTIONS, 256)
    assert enc.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(enc.numpy(), ref)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)


def test_model_params_match_jax():
    assert ttrain.get_model_params(PARAMS_DIR) == jtrain.get_model_params(PARAMS_DIR)


@pytest.mark.parametrize("preset", ["Base", "Super", "BaseTest", "SuperTest"])
def test_default_args_match_jax(preset):
    assert ttrain.get_default_args(getattr(T, preset)) == jtrain.get_default_args(getattr(J, preset))


@pytest.mark.parametrize("params_dir", [None, PARAMS_DIR], ids=["default", "parameters"])
def test_default_imagen_builds_train_py_cascade(params_dir):
    """The cascade's U-Net configs, sizes, schedule and encoder against the
    JAX Imagen ``train.py`` builds; the default one is built on the meta
    device (2.33B parameters, as counted in PERF.md)."""
    if params_dir is None:
        unets = [jtrain.get_default_args(J.Base), jtrain.get_default_args(J.Super)]
        imagen_params = dict(image_sizes=(64, 128), timesteps=1000, cond_drop_prob=0.15,
                             text_encoder_name="t5_base")
        ours = default_imagen(device="meta")
        assert sum(p.numel() for p in ours.unets.parameters()) == 2_334_226_054
    else:
        unets, imagen_params = jtrain.get_model_params(params_dir)
        imagen_params = {k: v for k, v in imagen_params.items()
                         if k not in ("unets", "only_train_unet_number")}
        ours = default_imagen(params_dir, device="cpu", dtype=torch.float32)
    ref = JImagen(unets=[J.UnetConfig.from_dict(p) for p in unets], **imagen_params)
    assert [c.to_dict() for c in ours.unet_configs] == [c.to_dict() for c in ref.unet_configs]
    assert tuple(ours.image_sizes) == tuple(ref.image_sizes)
    assert ours.text_encoder_name == ref.text_encoder_name
    assert ours.cond_drop_prob == ref.cond_drop_prob
    assert [s.num_timesteps for s in ours.noise_schedulers] == \
        [s.num_timesteps for s in ref.noise_schedulers]


# --------------------------------------------------------------------------- #
# narrow Base and Super                                                       #
# --------------------------------------------------------------------------- #
def _narrow(preset):
    return {**jtrain.get_default_args(getattr(J, preset)), "dim": 16}


@pytest.fixture(scope="module")
def narrow():
    """The narrow cascade in both packages with the port's seeded init,
    conditioned by t5_base's hash encodings of two captions."""
    kw = dict(image_sizes=SIZES, timesteps=1000, cond_drop_prob=0.15, text_encoder_name="t5_base")
    torch.manual_seed(0)
    configs = [_narrow("Base"), _narrow("Super")]
    ours = TImagen([T.UnetConfig(**c) for c in configs], device="cpu", **kw)
    ref = JImagen(unets=[J.UnetConfig(**c) for c in configs], **kw)
    params = {f"unet_{i}": _flax_tree(u) for i, u in enumerate(ours.unets)}
    enc, mask = Jt5._fallback_encode(CAPTIONS[3:3 + B], "t5_base", 256)
    return ours, ref, params, enc, mask


def _draws(ref, stage, key, b):
    """The draws of JAX's stage_loss_fn(stage) under `key`
    (imagen.py:1232-1243 and _p_losses), as numpy arrays."""
    times_key, aug_key, p_key = jax.random.split(key, 3)
    noise_key, lowres_key, drop_key = jax.random.split(p_key, 3)
    size = ref.image_sizes[stage]
    shape = (b, size, size, ref.channels)
    d = {"times": ref.noise_schedulers[stage].sample_random_times(times_key, b),
         "noise": jax.random.normal(noise_key, shape, jnp.float32),
         "keep_mask": jax.random.uniform(drop_key, (b,)) < 1.0 - ref.cond_drop_prob}
    if stage:
        d["lowres_aug_times"] = jnp.repeat(ref.lowres_noise_schedule.sample_random_times(aug_key, 1), b)
        d["lowres_noise"] = jax.random.normal(lowres_key, shape, jnp.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _stage_inputs(stage):
    """(guided-forward inputs, [0, 1] training images, loss key) of a stage."""
    rng = np.random.default_rng(20 + stage)
    size = SIZES[stage]
    fwd = dict(x=rng.normal(size=(B, size, size, 3)).astype(np.float32),
               t=np.array([17, 803], np.int32),
               low=rng.uniform(size=(B, size, size, 3)).astype(np.float32) if stage else None,
               low_t=np.array([200, 200], np.int32) if stage else None)
    images = rng.uniform(size=(B, SIZES[-1], SIZES[-1], 3)).astype(np.float32)
    return fwd, images, jax.random.PRNGKey(5 + stage)


@pytest.fixture(scope="module")
def jax_stage(narrow):
    """Per stage, once: the JAX package's guided forward (cond_scale 3) and
    its stage loss with the gradient, from one compiled function, with its
    own space-to-depth stem (``MINIMAGEN_TPU_STEM_FUSED=1``) and XLA's
    backend optimisations off (compile time; the arithmetic is the same)."""
    _, ref, params, enc, mask = narrow
    cache = {}

    def get(stage):
        if stage in cache:
            return cache[stage]
        fwd, images, key = _stage_inputs(stage)
        dup = lambda a: None if a is None else jnp.asarray(np.concatenate([a, a]))  # noqa: E731
        jin = dict(text_embeds=dup(enc), text_mask=dup(mask),
                   text_keep_mask=jnp.asarray([True] * B + [False] * B),
                   lowres_cond_img=dup(fwd["low"]), lowres_noise_times=dup(fwd["low_t"]))
        loss_fn = ref.stage_loss_fn(stage)

        def f(p, x, t, images, key):
            out = ref.unets[stage].apply({"params": p}, x, t, **jin)
            return loss_fn(p, images, jnp.asarray(enc), jnp.asarray(mask), key), out

        args = (params[f"unet_{stage}"], dup(fwd["x"]), dup(fwd["t"]), jnp.asarray(images), key)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MINIMAGEN_TPU_STEM_FUSED", "1")
            compiled = jax.jit(jax.value_and_grad(f, has_aux=True)).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0,
                                  "xla_llvm_disable_expensive_passes": True})
        (loss, out), grads = compiled(*args)
        out = np.asarray(out)
        cache[stage] = (out[B:] + (out[:B] - out[B:]) * 3.0, float(loss),
                        unet_state_dict(jax.tree_util.tree_map(np.asarray, grads)))
        return cache[stage]

    return get


def check_guided_forward(narrow, jax_stage, stage):
    """The port's guided forward (cond_scale 3) against the JAX package's."""
    ours, _, _, enc, mask = narrow
    want = jax_stage(stage)[0]
    fwd, _, _ = _stage_inputs(stage)
    cv = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    with torch.no_grad():
        got = ours._cfg_forward(stage, cv(fwd["x"]), cv(fwd["t"]), text_embeds=cv(enc),
                                text_mask=cv(mask), lowres_cond_img=cv(fwd["low"]),
                                lowres_noise_times=cv(fwd["low_t"]), cond_scale=3.0).numpy()
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


def check_stage_loss_gradient(narrow, jax_stage, stage):
    """The port's stage loss and its parameter gradient, with the JAX
    package's draws injected, against the JAX package's."""
    ours, ref, _, enc, mask = narrow
    _, jl, jgrads = jax_stage(stage)
    _, images, key = _stage_inputs(stage)
    unet = ours.unets[stage]
    unet.zero_grad(set_to_none=True)
    loss = ours.stage_loss(stage, torch.from_numpy(images), torch.from_numpy(enc),
                           torch.from_numpy(mask), **_draws(ref, stage, key, B))
    loss.backward()
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    grads = {name: p.grad for name, p in unet.named_parameters()}
    top = max(float(g.norm()) for g in jgrads.values())
    checked = 0
    for name, g in jgrads.items():
        if float(g.norm()) > 1e-3 * top:
            err = float((grads[name] - g).norm() / g.norm())
            assert err <= 1e-4, (name, err)
            checked += 1
    assert checked > len(jgrads) // 2
    assert grads["init_conv.conv_2.weight"] is not None  # the stem's 15x15 kernel


def test_narrow_base_guided_forward_matches_jax(narrow, jax_stage):
    check_guided_forward(narrow, jax_stage, 0)


def test_narrow_base_stage_loss_gradient_matches_jax(narrow, jax_stage):
    check_stage_loss_gradient(narrow, jax_stage, 0)


def test_auto_normalize_off_takes_images_in_minus_one_to_one():
    """``auto_normalize_img=False``: a stage loss on images y in [-1, 1]
    equals the default's on (y + 1) / 2 with the same draws (the resizes
    are linear and clamp to the matching range), and sampling returns
    [-1, 1] images."""
    torch.manual_seed(1)
    cfgs = [T.UnetConfig(**ttrain.get_default_args(T.BaseTest)),
            T.UnetConfig(**ttrain.get_default_args(T.SuperTest))]
    kw = dict(image_sizes=(8, 16), timesteps=25, text_encoder_name="t5_small", device="cpu")
    on = TImagen(cfgs, **kw)
    off = TImagen(cfgs, auto_normalize_img=False, **kw)
    off.unets = on.unets
    rng = np.random.default_rng(31)
    y = torch.from_numpy(rng.uniform(-1, 1, size=(B, 16, 16, 3)).astype(np.float32))
    enc, mask = (torch.from_numpy(a) for a in Jt5._fallback_encode(CAPTIONS[2:2 + B], "t5_small", 256))
    draws = dict(times=torch.tensor([3, 20]), lowres_aug_times=torch.tensor([7, 7]),
                 noise=torch.randn(B, 16, 16, 3), lowres_noise=torch.randn(B, 16, 16, 3),
                 keep_mask=torch.tensor([True, False]))
    with torch.no_grad():
        want = on.stage_loss(1, (y + 1) / 2, enc, mask, **draws)
        got = off.stage_loss(1, y, enc, mask, **draws)
        img = off.sample(text_embeds=enc, text_masks=mask, sampler="ddim", sample_steps=2,
                         generator=torch.Generator().manual_seed(0))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert float(img.min()) >= -1.0 and float(img.max()) <= 1.0 and float(img.min()) < 0.0
