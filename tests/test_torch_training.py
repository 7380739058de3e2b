"""The port's training against the JAX package on the CPU in float32, at the
same weights (the port's flax-style init carried over to a flax parameter
tree, the inverse of the port's checkpoint mapping) and with every random
draw injected as numpy arrays: U-Net parameter gradients, per-stage losses
with each loss lever, whole train steps (losses, parameters, EMA),
global-norm clipping, the flax-style init, the synthetic data, and the
float32-parameter / bfloat16-compute forward. At these widths the JAX
package takes its plain XLA paths on the CPU (its Pallas training kernels
are held against the port's plain versions in interpret mode by
``test_torch_train_ops.py``). Tolerances are stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimagen_tpu.data import collate as jcollate
from minimagen_tpu.data import dataset as jdata
from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.checkpoint import unet_state_dict
from minimagen_tpu_torch.data import collate as tcollate
from minimagen_tpu_torch.data import dataset as tdata
from minimagen_tpu_torch.models import unet as T
from minimagen_tpu_torch.models.imagen import Imagen as TImagen

BASE_KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
               layer_cross_attns=(False, True), attn_heads=2, attend_at_middle=True)
SR_KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=(1, 1), layer_attns=(False, True),
             layer_cross_attns=(False, True), attn_heads=2, memory_efficient=True)
SIZES = (8, 16)
T_STEPS = 100
B, L = 2, 5


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax_tree(module):
    """A port U-Net's parameters as a flax tree: ``weight`` -> ``kernel``,
    OIHW -> HWIO, (out, in) -> (in, out)."""
    tree = {}
    for name, p in module.state_dict().items():
        path = name.split(".")
        a = p.detach().numpy()
        if path[-1] == "weight":
            path[-1] = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(np.ascontiguousarray(a))
    return tree


def _pair(**levers):
    """The port's Imagen (flax-style init from seed 0) and the JAX Imagen
    with the same parameters."""
    kw = dict(image_sizes=SIZES, timesteps=T_STEPS, cond_drop_prob=0.1,
              text_encoder_name="t5_tiny", **levers)
    torch.manual_seed(0)
    ours = TImagen([T.UnetConfig(**BASE_KW), T.UnetConfig(**SR_KW)], device="cpu", **kw)
    ref = JImagen(unets=[J.UnetConfig(**BASE_KW), J.UnetConfig(**SR_KW)], **kw)
    params = {f"unet_{i}": _flax_tree(unet) for i, unet in enumerate(ours.unets)}
    return ours, ref, params


def test_flax_tree_round_trips_through_the_checkpoint_mapping(pair):
    ours, _, params = pair
    for i, unet in enumerate(ours.unets):
        back = unet_state_dict(_tree_np(params[f"unet_{i}"]))
        sd = unet.state_dict()
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), bool)
    mask[1, 3:] = False
    return {"image": rng.uniform(size=(B, SIZES[-1], SIZES[-1], 3)).astype(np.float32),
            "encoding": rng.normal(size=(B, L, 64)).astype(np.float32), "mask": mask}


def _rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30))


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax_draws(ref, key, step, b):
    """The draws of the JAX train step at `step` (mesh.py:346-347 and
    imagen.py:1164,1232-1243), as numpy arrays per stage."""
    keys = jax.random.split(jax.random.fold_in(key, step), ref.num_unets)
    draws = []
    for i, size in enumerate(ref.image_sizes):
        times_key, aug_key, p_key = jax.random.split(keys[i], 3)
        noise_key, lowres_key, drop_key = jax.random.split(p_key, 3)
        shape = (b, size, size, ref.channels)
        d = {"times": ref.noise_schedulers[i].sample_random_times(times_key, b),
             "noise": jax.random.normal(noise_key, shape, jnp.float32),
             "keep_mask": jax.random.uniform(drop_key, (b,)) < 1.0 - ref.cond_drop_prob}
        if i > 0:
            aug = ref.lowres_noise_schedule.sample_random_times(aug_key, 1)
            d["lowres_aug_times"] = jnp.repeat(aug, b)
            d["lowres_noise"] = jax.random.normal(lowres_key, shape, jnp.float32)
        draws.append({k: np.asarray(v) for k, v in d.items()})
    return draws


# --------------------------------------------------------------------------- #
# gradients and losses                                                        #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("stage", [0, 1], ids=["base", "sr_memory_efficient"])
def test_unet_parameter_gradients_match_jax(pair, stage):
    """d(sum(out * r))/d(params) of each U-Net: relative L2 within 1e-4 over
    each parameter with a gradient norm above 1e-3 of the largest."""
    ours, ref, params = pair
    size = SIZES[stage]
    rng = np.random.default_rng(1)
    batch = _batch(2)
    x = rng.normal(size=(B, size, size, 3)).astype(np.float32)
    r = rng.normal(size=(B, size, size, 3)).astype(np.float32)
    kw = dict(text_embeds=batch["encoding"], text_mask=batch["mask"],
              text_keep_mask=np.array([True, False]))
    if stage:
        kw.update(lowres_cond_img=rng.normal(size=x.shape).astype(np.float32),
                  lowres_noise_times=np.array([200, 200], np.int32))
    time = np.array([3, 871], np.int32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    @jax.jit
    def jgrad(p):
        def jloss(p):
            out = ref.unets[stage].apply({"params": p}, jnp.asarray(x), jnp.asarray(time), **jkw)
            return jnp.sum(out * jnp.asarray(r))
        return jax.grad(jloss)(p)

    jgrads = unet_state_dict(_tree_np(jgrad(params[f"unet_{stage}"])))
    unet = ours.unets[stage]
    unet.zero_grad(set_to_none=True)
    out = unet(torch.from_numpy(x), torch.from_numpy(time), **_torch(kw))
    (out * torch.from_numpy(r)).sum().backward()
    grads = {name: p.grad for name, p in unet.named_parameters()}
    assert set(grads) == set(jgrads)
    top = max(float(g.norm()) for g in jgrads.values())
    checked = 0
    for name, g in jgrads.items():
        if float(g.norm()) > 1e-3 * top:
            assert _rel_l2(grads[name].numpy(), g.numpy()) <= 1e-4, name
            checked += 1
    assert checked > len(jgrads) // 2


LEVERS = {"l2": dict(loss_type="l2"), "l1": dict(loss_type="l1"),
          "huber": dict(loss_type="huber"), "min_snr": dict(min_snr_gamma=5.0)}


@pytest.mark.parametrize("stage", [0, 1], ids=["base", "sr"])
def test_stage_losses_match_jax(pair, stage):
    """Each stage's loss at injected times, noise, low-res pair and keep mask
    (JAX's keep mask rebuilt from split(key, 3)[2]), for every loss lever
    (l2, l1, huber, min-SNR gamma 5); relative 1e-5."""
    ours, ref, params = pair
    size = SIZES[stage]
    batch = _batch(3)
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(10 + stage)
    x_start = rng.uniform(size=(B, size, size, 3)).astype(np.float32)
    times = np.array([5, 90], np.int32)
    noise = rng.normal(size=(B, size, size, 3)).astype(np.float32)
    low = lowres_noise = aug = None
    if stage:
        low = rng.uniform(size=(B, size, size, 3)).astype(np.float32)
        lowres_noise = rng.normal(size=low.shape).astype(np.float32)
        aug = np.array([40, 40], np.int32)
    keep = np.asarray(jax.random.uniform(jax.random.split(key, 3)[2], (B,)) < 0.9)
    cv = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    jv = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    for lever, kw in LEVERS.items():
        jimagen = JImagen(unets=[J.UnetConfig(**BASE_KW), J.UnetConfig(**SR_KW)],
                          image_sizes=SIZES, timesteps=T_STEPS, text_encoder_name="t5_tiny", **kw)
        jl = jax.jit(lambda p: jimagen._p_losses(
            stage, p, jv(x_start), jv(times), key=key, text_embeds=jv(batch["encoding"]),
            text_mask=jv(batch["mask"]), lowres_cond_img=jv(low), lowres_aug_times=jv(aug),
            noise=jv(noise), lowres_noise=jv(lowres_noise)))(params[f"unet_{stage}"])
        timagen = TImagen([T.UnetConfig(**BASE_KW), T.UnetConfig(**SR_KW)], image_sizes=SIZES,
                          timesteps=T_STEPS, text_encoder_name="t5_tiny", device="cpu", **kw)
        timagen.unets = ours.unets
        with torch.no_grad():
            tl = timagen.p_losses(stage, cv(x_start), cv(times), text_embeds=cv(batch["encoding"]),
                                  text_mask=cv(batch["mask"]), lowres_cond_img=cv(low),
                                  lowres_aug_times=cv(aug), noise=cv(noise),
                                  lowres_noise=cv(lowres_noise), keep_mask=cv(keep))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), (lever, float(tl), float(jl))


def test_offset_noise_and_lever_validation():
    """Offset noise adds scale * N(0, 1) per (sample, channel) to drawn noise
    only; the levers reject gamma <= 0 and a negative scale."""
    ours, _, _ = _pair(offset_noise_scale=0.1)
    batch = _torch(_batch(4))
    kw = dict(text_embeds=batch["encoding"], text_mask=batch["mask"],
              keep_mask=torch.tensor([True, True]))
    x, times = batch["image"][:, :8, :8], torch.tensor([10, 20])
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        drawn = ours.p_losses(0, x, times, generator=gen, **kw)
        gen = torch.Generator().manual_seed(3)
        noise = torch.randn(x.shape, generator=gen)
        noise = noise + 0.1 * torch.randn((B, 1, 1, 3), generator=gen)
        assert torch.equal(drawn, ours.p_losses(0, x, times, noise=noise, **kw))
    with pytest.raises(ValueError):
        ours.set_training_levers(min_snr_gamma=0.0)
    with pytest.raises(ValueError):
        ours.set_training_levers(offset_noise_scale=-1.0)


def test_train_steps_match_jax():
    """Two whole train steps, both stages, against the JAX make_train_step +
    make_optimizer with the same draws: losses within 2e-5 relative; every
    U-Net's parameters and EMA within 1e-5 relative L2, and the two steps'
    parameter update within 1e-3 relative L2 (it agrees to ~2e-4: Adam's
    lr * m / sqrt(v) turns float32 noise in gradients near zero into
    updates of up to lr)."""
    ours, ref, params = _pair()
    before = [p.detach().clone() for p in ttrain.unet_parameters(ours)]
    lr, decay = 1e-3, 0.9
    jopt = jmesh.make_optimizer(lr)
    jstate = jmesh.create_train_state(params, jopt, ema=True)
    jstep = jmesh.make_train_step(ref, jopt, donate=False, ema_decay=decay)
    topt = ttrain.make_optimizer(lr)
    tstate = ttrain.create_train_state(ours, topt, ema=True)
    tstep = ttrain.make_train_step(ours, topt, ema_decay=decay)
    key = jax.random.PRNGKey(11)
    for step in range(2):
        batch = _batch(5 + step)
        jstate, jlosses = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        draws = [_torch(d) for d in _jax_draws(ref, key, step, B)]
        tstate, tlosses = tstep(tstate, _torch(batch), draws=draws)
        np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=2e-5)
    assert tstate.step == 2
    offset = 0
    for i, unet in enumerate(ours.unets):
        names = [n for n, _ in unet.named_parameters()]
        count = len(names)
        flat = lambda ts: np.concatenate([np.asarray(t).ravel() for t in ts])  # noqa: E731
        jp = unet_state_dict(_tree_np(jstate.params[f"unet_{i}"]))
        je = unet_state_dict(_tree_np(jstate.ema_params[f"unet_{i}"]))
        p0 = flat(before[offset:offset + count])
        ours_p = flat(p.detach() for p in unet.parameters())
        ref_p = flat(jp[n] for n in names)
        assert _rel_l2(ours_p, ref_p) <= 1e-5
        assert _rel_l2(ours_p - p0, ref_p - p0) <= 1e-3
        assert _rel_l2(flat(tstate.ema_params[offset:offset + count]), flat(je[n] for n in names)) <= 1e-5
        offset += count


def test_clipping_matches_optax():
    """A gradient tree of global norm > 50 is scaled to 50 as optax's
    clip_by_global_norm does (torch adds 1e-6 to the norm: relative 1e-6)."""
    rng = np.random.default_rng(12)
    grads = [rng.normal(size=s).astype(np.float32) * 9.0 for s in [(40, 30), (7,), (3, 5, 2)]]
    ref, _ = optax.clip_by_global_norm(50.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = ttrain.make_optimizer(1e-3).clip(params)
    assert float(norm) > 50.0
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.02, 9.0], ids=["below-limit", "above-limit"])
def test_optax_style_clip_matches_clip_by_global_norm(scale):
    """The clip scales by min(1, 50 / norm), the norm in float32 over every
    leaf, as optax.clip_by_global_norm: below the limit the gradients keep
    their bits; above it they agree to 2 float32 ulps (optax divides by the
    norm and multiplies by 50, the port multiplies by 50 / norm)."""
    rng = np.random.default_rng(13)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in [(64, 48), (9,), (3, 3, 4, 8)]]
    ref, _ = optax.clip_by_global_norm(50.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = ttrain.make_optimizer(1e-3).clip(params)
    want = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads)))
    assert abs(float(norm) - want) <= 1e-6 * want
    assert (want > 50.0) == (scale > 1.0)
    for p, r, g in zip(params, ref, grads):
        if scale < 1.0:
            np.testing.assert_array_equal(p.grad.numpy(), g)
        np.testing.assert_array_max_ulp(p.grad.numpy(), np.asarray(r), maxulp=2)


# --------------------------------------------------------------------------- #
# init, dtypes, data                                                          #
# --------------------------------------------------------------------------- #
def test_init_matches_flax_statistics():
    """Each parameter kind against flax's init of the same U-Net: the pooled
    std of dense kernels and of conv kernels, each scaled by sqrt(fan_in),
    and of the null embeddings, within 10% of the JAX model's, as is every
    kernel of 4096 or more elements on its own; biases zero; norms one and
    zero."""
    kw = dict(dim=16, dim_mults=(1,), num_resnet_blocks=1, layer_attns=True,
              layer_cross_attns=True, attn_heads=2, attend_at_middle=True, text_embed_dim=64)
    jmodel = J.UnetModel(config=J.UnetConfig(**kw))
    x = jnp.zeros((1, 8, 8, 3))
    init = jax.jit(lambda key: jmodel.init(key, x, jnp.zeros((1,), jnp.int32),
                                           text_embeds=jnp.zeros((1, 4, 64)),
                                           text_mask=jnp.ones((1, 4), bool)))
    jparams = unet_state_dict(_tree_np(init(jax.random.PRNGKey(0))["params"]))
    torch.manual_seed(0)
    ours = dict(T.UnetModel(T.UnetConfig(**kw)).named_parameters())
    assert set(ours) == set(jparams)
    pooled = {"dense": ([], []), "conv": ([], []), "null": ([], [])}
    for name, ref in jparams.items():
        p = ours[name].detach()
        assert p.shape == ref.shape, name
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "g", "scale") or (leaf == "beta" and "norm" in name):
            assert torch.equal(p, ref), name  # norms: ones / zeros
        elif leaf in ("bias", "beta"):
            assert not p.any() and not ref.any(), name
        elif leaf.startswith("null"):
            pooled["null"][0].append(p.ravel())
            pooled["null"][1].append(ref.ravel())
        else:
            fan_in = p[0].numel()
            kind = "conv" if p.ndim == 4 else "dense"
            pooled[kind][0].append(p.ravel() * fan_in ** 0.5)
            pooled[kind][1].append(ref.ravel() * fan_in ** 0.5)
            if p.numel() >= 4096:
                assert 0.9 <= float(p.std()) / float(ref.std()) <= 1.1, name
    for kind, (a, b) in pooled.items():
        ratio = float(torch.cat(a).std()) / float(torch.cat(b).std())
        assert 0.9 <= ratio <= 1.1, (kind, ratio)


def test_f32_params_bf16_compute_is_bit_equal_to_bf16_params():
    """float32 master parameters that hold bf16 values, cast at use, give
    the bf16-parameter forward bit for bit."""
    cfg = T.UnetConfig(**{**BASE_KW, "text_embed_dim": 64})
    torch.manual_seed(1)
    bf16 = T.UnetModel(cfg, dtype=torch.bfloat16)
    f32 = T.UnetModel(cfg, dtype=torch.bfloat16, param_dtype=torch.float32)
    f32.load_state_dict({k: v.float() for k, v in bf16.state_dict().items()})
    assert all(p.dtype == torch.float32 for p in f32.parameters())
    batch = _torch(_batch(8))
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(B, 16, 16, 3)).astype(np.float32))
    kw = dict(text_embeds=batch["encoding"], text_mask=batch["mask"],
              text_keep_mask=torch.tensor([True, False]))
    with torch.no_grad():
        a = bf16(x, torch.tensor([3, 500]), **kw)
        b = f32(x, torch.tensor([3, 500]), **kw)
    assert torch.equal(a, b)


def test_synthetic_data_matches_jax():
    """Drawing, the holdout split, the held-out item order and collation are
    the JAX package's bit for bit."""
    assert tdata.holdout_split(3) == jdata.holdout_split(3)
    train, held = tdata.holdout_split(3)
    assert held == [0, 10, 13]
    for index in (0, 5, 17, 100):
        img, cap = tdata._draw_synthetic(index, 32)
        jimg, jcap = jdata._draw_synthetic(index, 32)
        assert cap == jcap and img.dtype == jimg.dtype and np.array_equal(img, jimg)
    assert [tdata.synthetic_combo_caption(i) for i in range(18)] == \
        [jdata.synthetic_combo_caption(i) for i in range(18)]
    ours = tdata.SyntheticCaptionedImages(num_items=40, side_length=16, encoder_name="t5_tiny",
                                          max_length=16, combos=train, device="cpu")
    ref = jdata.SyntheticCaptionedImages(num_items=40, side_length=16, encoder_name="t5_tiny",
                                         max_length=16, combos=train)
    assert [ours._underlying_index(i) for i in range(40)] == \
        [ref._underlying_index(i) for i in range(40)]
    items = [ours[i] for i in range(4)]
    assert items[0]["encoding"].shape == (4, 64) and items[0]["mask"].all()  # "a red circle" + EOS
    got = tcollate.MinimagenCollator(max_length=16)(items)
    want = jcollate.MinimagenCollator(max_length=16)(items)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_forward_trains_one_stage_from_captions():
    """Imagen.forward encodes captions and returns a finite scalar loss that
    backpropagates into the chosen U-Net only."""
    ours, _, _ = _pair()
    images = torch.from_numpy(_batch(6)["image"])
    with pytest.raises(ValueError):
        ours.forward(images, texts=["a red square", "a blue circle"])
    loss = ours.forward(images, texts=["a red square", "a blue circle"], unet_number=2,
                        generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert all(p.grad is None for p in ours.unets[0].parameters())
    assert all(p.grad is not None for p in ours.unets[1].parameters())
