"""The port's sampling levers against the JAX Imagen on the CPU in float32,
at the same weights (the dim-16 pair of ``test_torch_sampling.py``), with
every random draw injected as numpy arrays: the U-Net's encoder-feature
cache (returned and reused), ``forward_with_cond_scale`` with the guidance
rescale, the rescale alone (also on a near-constant prediction, where the
population std matters),
short two-stage DPM-Solver++ and UniPC cascades across the grids with and
without caching, truncated ``super_resolve`` with each strided solver
(relative 2e-3 of the largest value), and the caching cost model's exact
numbers. Port-only checks: ``cache_interval=1`` gives the same bits as no
cache, ``'auto'`` samples as the interval it resolves to, ``data_format``,
``return_pil_images`` and the progress bar. The JAX side runs its plain
XLA versions of its Pallas kernels (``_plain_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimagen_tpu.ops.helpers import normalize_neg_one_to_one as j_normalize
from minimagen_tpu.ops.resize import resize_image_to as j_resize
from minimagen_tpu_torch.models import imagen as timagen
from minimagen_tpu_torch.models.unet import encoder_cache_shapes
from test_torch_sampling import (  # noqa: F401 (the fixtures are used by name)
    B, COND_SCALE, SIZES, _close, _injector, _noise, _text, pair,
)


@pytest.fixture(autouse=True)
def _plain_jax(monkeypatch):
    """The JAX package's plain XLA versions in place of its Pallas kernels,
    as it runs on a CPU without interpret mode: these tests hold the cache,
    the combine and the sampling algebra, which the kernels do not touch
    (``test_torch_sampling.py`` holds them in interpret mode), and a scan
    over interpret-mode kernels takes tens of seconds to compile."""
    monkeypatch.delenv("MINIMAGEN_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.setenv("MINIMAGEN_TPU_DISABLE_PALLAS", "1")


@pytest.mark.parametrize("stage", [0, 1])
def test_unet_encoder_cache_against_jax(pair, stage):
    """The returned cache equals the JAX package's, tensor by tensor; reusing
    it at another timestep agrees with JAX reusing its own, and reusing it a
    second time gives the same bits as the first (the up path must not eat
    the cached hiddens)."""
    ours, ref, params = pair
    embeds, mask = _text(20 + stage)
    size = SIZES[stage]
    x = _noise((B, size, size, 3), 21 + stage)
    kw = dict(text_embeds=embeds, text_mask=mask)
    if stage:
        kw.update(lowres_cond_img=_noise((B, size, size, 3), 23),
                  lowres_noise_times=np.array([20, 20], np.int32))
    t0, t1 = np.array([70, 30], np.int32), np.array([55, 12], np.int32)
    apply = jax.jit(lambda p, xx, tt, cache, **k: ref.unets[stage].apply(
        {"params": p}, xx, tt, encoder_cache=cache, return_encoder_cache=cache is None, **k))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jout, jcache = apply(params[f"unet_{stage}"], jnp.asarray(x), jnp.asarray(t0), None, **jkw)
    jreuse = apply(params[f"unet_{stage}"], jnp.asarray(x), jnp.asarray(t1), jcache, **jkw)
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    unet = ours.unets[stage]
    with torch.no_grad():
        out, cache = unet(torch.from_numpy(x), torch.from_numpy(t0), return_encoder_cache=True,
                          **tkw)
        reuse = [unet(torch.from_numpy(x), torch.from_numpy(t1), encoder_cache=cache, **tkw)
                 for _ in range(2)]
    assert isinstance(cache, tuple) and isinstance(cache[1], tuple)
    ours_leaves = [cache[0], *cache[1]]
    jax_leaves = jax.tree_util.tree_leaves(jcache)
    assert [tuple(t.shape) for t in ours_leaves] == [tuple(a.shape) for a in jax_leaves] \
        == encoder_cache_shapes(ours.unet_configs[stage], B, size)
    for got, want in zip(ours_leaves, jax_leaves):
        _close(got.numpy(), want, 1e-3)
    _close(out.numpy(), jout, 1e-3)
    _close(reuse[0].numpy(), jreuse, 1e-3)
    assert torch.equal(reuse[0], reuse[1])
    assert not torch.allclose(reuse[0], out)


@pytest.mark.parametrize("offset,spread", [(0.3, 0.5), (1e-7, 1e-9)],
                         ids=["ordinary", "near_constant"])
def test_guidance_rescale_combine_against_jax(pair, monkeypatch, offset, spread):
    """The combine alone, on predictions stubbed into JAX's `_cfg_forward`.
    Near a constant the guided std falls under the 1e-8 floor, and the
    population std (`jnp.std`) against the sample std (torch's default)
    moves the result by far more than the tolerance."""
    _, ref, params = pair
    rng = np.random.default_rng(26)
    out2b = (offset + spread * rng.normal(size=(2 * B, 16, 16, 3))).astype(np.float32)
    monkeypatch.setattr(ref, "_unet_forward", lambda *a, **k: jnp.asarray(out2b))
    x = jnp.zeros((B, 16, 16, 3))
    jout = np.asarray(ref._cfg_forward(0, params["unet_0"], x, jnp.zeros((B,), jnp.int32),
                                       text_embeds=None, text_mask=None, lowres_cond_img=None,
                                       lowres_noise_times=None, cond_scale=COND_SCALE,
                                       guidance_rescale=0.7))
    cond, null = torch.from_numpy(out2b[:B]), torch.from_numpy(out2b[B:])
    got = timagen.guided_combine(cond, null, COND_SCALE, 0.7).numpy()
    scale = float(np.abs(jout).max())
    assert float(np.abs(got - jout).max()) <= 1e-5 * scale
    if spread < 1e-8:  # the test tells the two stds apart
        guided = null + (cond - null) * COND_SCALE
        std_pos = torch.std(cond, dim=(1, 2, 3), keepdim=True)  # correction=1
        wrong = 0.7 * guided * std_pos / 1e-8 + 0.3 * guided
        assert float(np.abs(wrong.numpy() - jout).max()) > 10 * 1e-5 * scale


@pytest.mark.parametrize("cond_scale,rescale", [(1.0, 0.0), (COND_SCALE, 0.7)],
                         ids=["plain", "guided_rescaled"])
def test_forward_with_cond_scale_against_jax(pair, cond_scale, rescale):
    ours, ref, params = pair
    embeds, mask = _text(27)
    x, low = _noise((B, 32, 32, 3), 28), _noise((B, 32, 32, 3), 29)
    t, times = np.array([40, 90]), np.array([20, 20])
    jout = ref.forward_with_cond_scale(
        jnp.asarray(x), jnp.asarray(t, jnp.int32), unet_number=2, cond_scale=cond_scale,
        guidance_rescale=rescale, params=params, text_embeds=jnp.asarray(embeds),
        text_mask=jnp.asarray(mask), lowres_cond_img=jnp.asarray(low),
        lowres_noise_times=jnp.asarray(times, jnp.int32))
    with torch.no_grad():
        out = ours.forward_with_cond_scale(
            torch.from_numpy(x), torch.from_numpy(t), unet_number=2, cond_scale=cond_scale,
            guidance_rescale=rescale, text_embeds=torch.from_numpy(embeds),
            text_mask=torch.from_numpy(mask), lowres_cond_img=torch.from_numpy(low),
            lowres_noise_times=torch.from_numpy(times))
    _close(out.numpy(), jout, 1e-3)


def _jax_cascade(ref, params, embeds, mask, noises, steps, sr_level, **stage_kw):
    """The JAX package's cascade stage by stage, draws injected in the
    port's order (base init, augmentation noise, super-res init)."""
    n0, aug, n1 = (jnp.asarray(a) for a in noises)
    key = jax.random.PRNGKey(0)
    embeds, mask = jnp.asarray(embeds), jnp.asarray(mask)
    sampler, grid = stage_kw["sampler"], stage_kw["grid"]
    fn0 = ref._build_sample_stage(0, True, sample_steps=steps[0], **stage_kw)
    img0 = fn0(params["unet_0"], key, embeds, mask, jnp.float32(COND_SCALE), init_noise=n0)
    times = ref.lowres_noise_schedule.get_times(B, 0.2)
    lowres = ref.lowres_noise_schedule.q_sample(j_resize(img0, SIZES[1]), times, aug)
    start_at, init = None, n1
    if sr_level is not None:
        start_at = ref._truncation_start(1, sr_level, sampler, steps[1], grid)
        init = ref.noise_schedulers[1].q_sample(
            j_normalize(j_resize(img0, SIZES[1])), jnp.full((B,), start_at, jnp.int32), n1)
    fn1 = ref._build_sample_stage(1, True, sample_steps=steps[1], start_at=start_at, **stage_kw)
    img1 = fn1(params["unet_1"], key, embeds, mask, jnp.float32(COND_SCALE), lowres, times, init)
    return np.asarray(img0), np.asarray(img1)


# every solver on every grid, each with and without caching, some guided
# with the rescale, some truncated
CASCADES = [("dpmpp", "time", 2, 0.0, None), ("dpmpp", "lambda", None, 0.7, 0.3),
            ("dpmpp", "karras", 2, 0.0, 0.3), ("unipc", "time", None, 0.7, None),
            ("unipc", "lambda", 2, 0.7, None), ("unipc", "karras", None, 0.0, 0.3)]


@pytest.mark.parametrize("sampler,grid,cache,rescale,sr_level", CASCADES,
                         ids=[f"{s}-{g}-cache{c}-phi{r}-sr{l}" for s, g, c, r, l in CASCADES])
def test_solver_cascade_against_jax(pair, sampler, grid, cache, rescale, sr_level):
    ours, ref, params = pair
    embeds, mask = _text(30)
    steps = (4, 8)
    noises = [_noise((B, 16, 16, 3), 31), _noise((B, 32, 32, 3), 32), _noise((B, 32, 32, 3), 33)]
    jimg0, jimg1 = _jax_cascade(ref, params, embeds, mask, noises, steps, sr_level,
                                sampler=sampler, grid=grid, cache_interval=cache,
                                guidance_rescale=rescale)
    timg0, timg1 = ours.sample(text_embeds=torch.from_numpy(embeds),
                               text_masks=torch.from_numpy(mask), cond_scale=COND_SCALE,
                               sampler=sampler, sample_steps=steps, grid=grid,
                               cache_interval=cache, guidance_rescale=rescale,
                               sr_start_noise_levels=sr_level, noise=_injector(noises),
                               return_all_stage_outputs=True)
    _close(timg0.numpy(), jimg0, 2e-3)
    _close(timg1.numpy(), jimg1, 2e-3)


@pytest.mark.parametrize("sampler,grid,cache", [("ddim", "lambda", 2), ("dpmpp", "karras", None),
                                                ("unipc", "lambda", 2)])
def test_truncated_super_resolve_against_jax(pair, sampler, grid, cache):
    """The start snaps onto the chosen grid for every strided solver, and
    the init is noised at the first t the solver processes."""
    ours, ref, params = pair
    embeds, mask = _text(34)
    images = np.random.default_rng(35).uniform(size=(B, 16, 16, 3)).astype(np.float32)
    aug, n1 = _noise((B, 32, 32, 3), 36), _noise((B, 32, 32, 3), 37)
    steps, level = 12, 0.45
    start_at = ref._truncation_start(1, level, sampler, steps, grid)
    assert ours._truncation_start(1, level, sampler, steps, grid) == start_at
    assert start_at in ref.noise_schedulers[1].strided_sampling_timesteps(steps, grid)[:, 0]
    times = ref.lowres_noise_schedule.get_times(B, 0.2)
    lowres = ref.lowres_noise_schedule.q_sample(j_resize(jnp.asarray(images), 32), times,
                                                jnp.asarray(aug))
    init = ref.noise_schedulers[1].q_sample(j_normalize(j_resize(jnp.asarray(images), 32)),
                                            jnp.full((B,), start_at, jnp.int32), jnp.asarray(n1))
    fn = ref._build_sample_stage(1, True, sampler, sample_steps=steps, start_at=start_at,
                                 grid=grid, cache_interval=cache)
    jimg = fn(params["unet_1"], jax.random.PRNGKey(0), jnp.asarray(embeds), jnp.asarray(mask),
              jnp.float32(COND_SCALE), lowres, times, init)
    timg = ours.super_resolve(images, text_embeds=torch.from_numpy(embeds),
                              text_masks=torch.from_numpy(mask), cond_scale=COND_SCALE,
                              sampler=sampler, sample_steps=steps, grid=grid,
                              cache_interval=cache, start_noise_level=level,
                              noise=_injector([aug, n1]))
    _close(timg.numpy(), jimg, 2e-3)


@pytest.mark.parametrize("stage,rows", [(0, 4), (1, 16)])
def test_cache_cost_model_matches_jax(pair, stage, rows):
    """cache_bytes and down_flops_est are exact and equal the JAX
    package's; 'auto' resolves to 2 exactly where the port's model says so."""
    ours, ref, _ = pair
    got = ours.encoder_cache_cost_model(stage, rows, 5)
    want = ref.encoder_cache_cost_model(stage, rows, 5)
    assert got["cache_bytes"] == want["cache_bytes"]
    assert got["down_flops_est"] == want["down_flops_est"]
    assert set(got) == set(want)
    assert ours._resolve_cache_interval("auto", stage, rows, 5) == (2 if got["enable"] else None)
    assert ours._resolve_cache_interval(3, stage, rows, 5) == 3


def _base_stage(ours, sampler, cache, seed=41):
    embeds, mask = (torch.from_numpy(a) for a in _text(40))
    init = torch.from_numpy(_noise((B, 16, 16, 3), seed))
    gen = torch.Generator().manual_seed(0)
    return ours.sample_stage(0, embeds, mask, COND_SCALE, init_noise=init, sampler=sampler,
                             sample_steps=5, start_at=7 if sampler == "ddpm" else None,
                             grid="lambda", cache_interval=cache, guidance_rescale=0.5,
                             generator=gen)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp", "unipc"])
def test_cache_interval_one_is_bit_identical(pair, sampler):
    ours, _, _ = pair
    off = _base_stage(ours, sampler, None)
    assert torch.equal(_base_stage(ours, sampler, 1), off)
    assert torch.equal(_base_stage(ours, sampler, 0), off)
    assert not torch.equal(_base_stage(ours, sampler, 2), off)


def test_auto_samples_as_the_interval_it_resolves_to(pair):
    ours, _, _ = pair
    embeds, mask = (torch.from_numpy(a) for a in _text(42))
    runs = {}
    for cache in ("auto", 2, None):
        runs[cache] = ours.sample(text_embeds=embeds, text_masks=mask, cond_scale=COND_SCALE,
                                  sampler="dpmpp", sample_steps=3, cache_interval=cache,
                                  generator=torch.Generator().manual_seed(5))
    resolved = [ours._resolve_cache_interval("auto", s, 2 * B, mask.shape[1]) for s in (0, 1)]
    assert len(set(resolved)) == 1, "the stages resolve differently; compare per stage"
    assert torch.equal(runs["auto"], runs[resolved[0]])


def test_data_format_pil_and_progress(pair, capsys):
    ours, _, _ = pair
    embeds, mask = (torch.from_numpy(a) for a in _text(43))
    kw = dict(text_embeds=embeds, text_masks=mask, cond_scale=COND_SCALE, sampler="unipc",
              sample_steps=3, cache_interval=None)
    run = lambda **k: ours.sample(generator=torch.Generator().manual_seed(6), **kw, **k)  # noqa: E731
    nhwc = run()
    nchw = run(data_format="NCHW", progress=True)
    assert torch.equal(nchw, nhwc.permute(0, 3, 1, 2))
    err = capsys.readouterr().err
    assert "sampling stage 1/2" in err and "sampling stage 2/2" in err and "3/3" in err
    both = run(data_format="NCHW", return_all_stage_outputs=True)
    assert [tuple(o.shape) for o in both] == [(B, 3, 16, 16), (B, 3, 32, 32)]
    pil = run(return_pil_images=True)
    assert len(pil) == B and pil[0].size == (32, 32) and pil[0].mode == "RGB"
    want = (nhwc[0].numpy() * 255.0 + 0.5).astype(np.uint8)
    assert np.array_equal(np.asarray(pil[0]), want)
    with pytest.raises(ValueError):
        run(data_format="CHWN")
