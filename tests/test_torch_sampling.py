"""The port's cascade sampling against the JAX Imagen on the CPU in float32,
at the same weights, with every random draw injected as numpy arrays (the
two frameworks' generators differ): one guided DDIM step and one guided DDPM
step (relative 1e-3 of the largest value), and short two-stage cascades,
full-reverse and truncated, plus ``super_resolve`` (relative 2e-3). The JAX
side runs its Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.models.unet import UnetConfig as JConfig
from minimagen_tpu.ops.helpers import normalize_neg_one_to_one as j_normalize
from minimagen_tpu.ops.resize import resize_image_to as j_resize
from minimagen_tpu_torch.checkpoint import unet_state_dict
from minimagen_tpu_torch.models.imagen import Imagen as TImagen
from minimagen_tpu_torch.models.unet import UnetConfig as TConfig

BASE_KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
               layer_cross_attns=(False, True), attn_heads=2, attend_at_middle=True)
SR_KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1), layer_attns=(False, True),
             layer_cross_attns=(False, True), attn_heads=2, memory_efficient=True)
SIZES = (16, 32)
T_STEPS = 100
B, L = 2, 5
COND_SCALE = 3.0


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MINIMAGEN_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def pair():
    kw = dict(image_sizes=SIZES, timesteps=T_STEPS, cond_drop_prob=0.1,
              text_encoder_name="t5_tiny")
    ours = TImagen([TConfig(**BASE_KW), TConfig(**SR_KW)], device="cpu", **kw)
    ref = JImagen(unets=[JConfig(**BASE_KW), JConfig(**SR_KW)], **kw)
    params = ref.init_params(jax.random.PRNGKey(0), batch_size=B, text_len=L)
    for i, unet in enumerate(ours.unets):
        tree = jax.tree_util.tree_map(np.asarray, params[f"unet_{i}"])
        unet.load_state_dict(unet_state_dict(tree), strict=True)
    return ours, ref, params


def _text(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), bool)
    mask[1, 3:] = False
    return rng.normal(size=(B, L, 64)).astype(np.float32), mask


def _noise(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _injector(arrays):
    it = iter(arrays)

    def draw(shape):
        a = next(it)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a)

    return draw


def _close(ours, ref, rel):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), f"max abs diff {err}"


def _kw(embeds, mask, lowres=None, times=None, framework=np):
    conv = (lambda a: None if a is None else jnp.asarray(a)) if framework is jnp else \
        (lambda a: None if a is None else torch.from_numpy(np.asarray(a)))
    return dict(text_embeds=conv(embeds), text_mask=conv(mask), lowres_cond_img=conv(lowres),
                lowres_noise_times=conv(times), cond_scale=COND_SCALE, guided=True)


def test_one_guided_ddim_step(pair):
    ours, ref, params = pair
    embeds, mask = _text()
    x = _noise((B, 16, 16, 3), 1)
    t, tp = np.array([60, 60]), np.array([40, 40])
    sched = ref.noise_schedulers[0]
    jx0 = ref._predict_x_start(0, sched, params["unet_0"], jnp.asarray(x), jnp.asarray(t, jnp.int32),
                               **_kw(embeds, mask, framework=jnp))
    jimg = sched.ddim_step(jnp.asarray(x), jx0, jnp.asarray(t, jnp.int32), jnp.asarray(tp, jnp.int32))
    with torch.no_grad():
        tx0 = ours._predict_x_start(0, torch.from_numpy(x), torch.from_numpy(t), **_kw(embeds, mask))
        timg = ours.noise_schedulers[0].ddim_step(torch.from_numpy(x), tx0, torch.from_numpy(t),
                                                  torch.from_numpy(tp))
    _close(tx0.numpy(), jx0, 1e-3)
    _close(timg.numpy(), jimg, 1e-3)


def test_one_guided_ddpm_step_super_res(pair):
    ours, ref, params = pair
    embeds, mask = _text(2)
    x, lowres, eps = _noise((B, 32, 32, 3), 3), _noise((B, 32, 32, 3), 4), _noise((B, 32, 32, 3), 5)
    t, times = np.array([30, 30]), np.array([20, 20])
    mean, _, log_var = ref._p_mean_variance(
        1, ref.noise_schedulers[1], params["unet_1"], jnp.asarray(x), jnp.asarray(t, jnp.int32),
        **_kw(embeds, mask, lowres, times.astype(np.int32), framework=jnp))
    jimg = np.asarray(mean + jnp.exp(0.5 * log_var) * eps)
    with torch.no_grad():
        tmean, _, tlog_var = ours._p_mean_variance(1, torch.from_numpy(x), torch.from_numpy(t),
                                                   **_kw(embeds, mask, lowres, times))
    _close((tmean + torch.exp(0.5 * tlog_var) * torch.from_numpy(eps)).numpy(), jimg, 1e-3)


def _jax_cascade(ref, params, embeds, mask, noises, steps, sr_level):
    """The JAX package's cascade, stage by stage, with the draws injected
    in the port's order: base init, augmentation noise, super-res init."""
    n0, aug, n1 = (jnp.asarray(a) for a in noises)
    key = jax.random.PRNGKey(0)
    embeds, mask = jnp.asarray(embeds), jnp.asarray(mask)
    fn0 = ref._build_sample_stage(0, True, "ddim", sample_steps=steps[0])
    img0 = fn0(params["unet_0"], key, embeds, mask, jnp.float32(COND_SCALE), init_noise=n0)
    times = ref.lowres_noise_schedule.get_times(B, 0.2)
    lowres = ref.lowres_noise_schedule.q_sample(j_resize(img0, SIZES[1]), times, aug)
    start_at, init = None, n1
    if sr_level is not None:
        start_at = ref._truncation_start(1, sr_level, "ddim", steps[1], "time")
        init = ref.noise_schedulers[1].q_sample(
            j_normalize(j_resize(img0, SIZES[1])), jnp.full((B,), start_at, jnp.int32), n1)
    fn1 = ref._build_sample_stage(1, True, "ddim", sample_steps=steps[1], start_at=start_at)
    img1 = fn1(params["unet_1"], key, embeds, mask, jnp.float32(COND_SCALE), lowres, times, init)
    return np.asarray(img0), np.asarray(img1)


@pytest.mark.parametrize("steps,sr_level", [((3, 3), None), ((3, 6), 0.2)],
                         ids=["full_reverse", "truncated_0.2"])
def test_cascade_with_injected_noise(pair, steps, sr_level):
    ours, ref, params = pair
    embeds, mask = _text(6)
    noises = [_noise((B, 16, 16, 3), 7), _noise((B, 32, 32, 3), 8), _noise((B, 32, 32, 3), 9)]
    jimg0, jimg1 = _jax_cascade(ref, params, embeds, mask, noises, steps, sr_level)
    timg0, timg1 = ours.sample(text_embeds=torch.from_numpy(embeds), text_masks=torch.from_numpy(mask),
                               cond_scale=COND_SCALE, sampler="ddim", sample_steps=steps,
                               sr_start_noise_levels=sr_level, noise=_injector(noises),
                               return_all_stage_outputs=True)
    _close(timg0.numpy(), jimg0, 2e-3)
    _close(timg1.numpy(), jimg1, 2e-3)
    assert timg1.shape == (B, 32, 32, 3) and 0.0 <= float(timg1.min()) <= float(timg1.max()) <= 1.0


def test_super_resolve_with_injected_noise(pair):
    ours, ref, params = pair
    embeds, mask = _text(10)
    images = np.random.default_rng(11).uniform(size=(B, 16, 16, 3)).astype(np.float32)
    aug, n1 = _noise((B, 32, 32, 3), 12), _noise((B, 32, 32, 3), 13)
    start_at = ref._truncation_start(1, 0.3, "ddim", 6, "time")
    times = ref.lowres_noise_schedule.get_times(B, 0.2)
    lowres = ref.lowres_noise_schedule.q_sample(j_resize(jnp.asarray(images), 32), times,
                                                jnp.asarray(aug))
    init = ref.noise_schedulers[1].q_sample(j_normalize(j_resize(jnp.asarray(images), 32)),
                                            jnp.full((B,), start_at, jnp.int32), jnp.asarray(n1))
    fn = ref._build_sample_stage(1, True, "ddim", sample_steps=6, start_at=start_at)
    jimg = fn(params["unet_1"], jax.random.PRNGKey(0), jnp.asarray(embeds), jnp.asarray(mask),
              jnp.float32(COND_SCALE), lowres, times, init)
    timg = ours.super_resolve(images, text_embeds=torch.from_numpy(embeds),
                              text_masks=torch.from_numpy(mask), cond_scale=COND_SCALE,
                              sample_steps=6, start_noise_level=0.3, noise=_injector([aug, n1]))
    _close(timg.numpy(), jimg, 2e-3)


@pytest.mark.parametrize("level,steps", [(0.2, 50), (0.2, 6), (0.55, 10), (1.0, 50)])
def test_truncation_start_matches_jax(pair, level, steps):
    ours, ref, _ = pair
    assert ours._truncation_start(1, level, "ddim", steps) == \
        ref._truncation_start(1, level, "ddim", steps, "time")
    assert ours._truncation_start(1, level, "ddpm", None) == \
        ref._truncation_start(1, level, "ddpm", None, "time")


def test_sample_draws_from_generator_reproducibly(pair):
    ours, _, _ = pair
    embeds, mask = (torch.from_numpy(a) for a in _text(14))
    runs = [ours.sample(text_embeds=embeds, text_masks=mask, cond_scale=COND_SCALE,
                        sampler="ddim", sample_steps=2,
                        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (B, 32, 32, 3)
