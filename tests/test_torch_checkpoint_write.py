"""Checkpoint writing of the port against flax and the JAX package on the
CPU: the msgpack encoder (bytes equal to ``flax.serialization``'s, and
each side decodes the other's), one U-Net checkpoint each way, a full train
state each way (with and without gradient accumulation, a bfloat16 first
moment and the EMA; every leaf equal), and whole training directories: one
written by the port's ``MinimagenTrain`` (the reference's test widths, 2
steps) loads into JAX ``load_minimagen``, one written by the JAX package's
helpers into the port's, and the two packages' DDIM cascades from them with
the same injected draws agree within 1e-4 relative L2 in float32 (the
JAX sampling stages compile once, for both directories)."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from minimagen_tpu import generate as jgen
from minimagen_tpu import training as jtrain
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import checkpoint as tckpt
from minimagen_tpu_torch import generate as tgen
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.data.collate import DataLoader, MinimagenCollator
from minimagen_tpu_torch.data.dataset import SyntheticCaptionedImages
from minimagen_tpu_torch.models import unet as T
from minimagen_tpu_torch.models.imagen import Imagen as TImagen

KW = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
          layer_cross_attns=(False, True), attn_heads=2, attend_at_middle=True)
IMAGEN_KW = dict(image_sizes=(8, 16), timesteps=25, cond_drop_prob=0.15,
                 text_encoder_name="t5_small")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_msgpack_encoder_matches_flax():
    rng = np.random.default_rng(0)
    tree = {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 4, 70000 // 36)).astype(np.float32),
                                "bias": np.zeros(5, np.float32)},
                       "w": rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16)},
            "step": np.asarray(7, np.int32), "scalar": np.float32(1.5), "none": None,
            "empty": {}, "ints": [0, 127, 128, -1, -33, 70000, -70000, 2 ** 40],
            "text": "x" * 40, "flag": True, "f": 0.25}
    ours_tree = dict(tree, params=dict(tree["params"], w=torch.from_numpy(
        np.asarray(tree["params"]["w"]).view(np.int16)).view(torch.bfloat16)))
    ours = tckpt.msgpack_serialize(ours_tree)
    assert ours == serialization.msgpack_serialize(tree)
    back = tckpt.msgpack_restore(ours)
    ref = serialization.msgpack_restore(ours)
    assert _flat(back).keys() == _flat(ref).keys()
    for k, v in _flat(ref).items():
        if isinstance(v, str):
            assert _flat(back)[k] == v
            continue
        np.testing.assert_array_equal(np.asarray(_flat(back)[k], np.float64),
                                      np.asarray(v, np.float64), err_msg=k)


def test_unet_checkpoint_both_ways(tmp_path):
    """A U-Net written by the port is read by JAX ``load_unet_checkpoint``
    (flax restores against a template of the JAX tree's structure) leaf for
    leaf, and one written by JAX is loaded by the port, bit for bit."""
    cfg = T.UnetConfig(**KW, text_embed_dim=64)
    torch.manual_seed(3)
    ours = T.UnetModel(cfg)
    torch.manual_seed(4)
    other = T.UnetModel(cfg)
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, np.float32),
                                      tckpt.flax_unet_tree(other))
    tckpt.save_unet_checkpoint(str(tmp_path / "port.ckpt"), ours)
    loaded = jtrain.load_unet_checkpoint(str(tmp_path / "port.ckpt"), template)
    sd = tckpt.unet_state_dict(jax.tree_util.tree_map(np.asarray, loaded))
    assert sd.keys() == ours.state_dict().keys()
    for k, v in ours.state_dict().items():
        assert torch.equal(sd[k], v), k
    jax_tree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tckpt.flax_unet_tree(other))
    jtrain.save_unet_checkpoint(str(tmp_path / "jax.ckpt"), jax_tree)
    assert (tmp_path / "jax.ckpt").read_bytes() == tckpt.msgpack_serialize(
        tckpt.flax_unet_tree(other))
    tckpt.load_unet_checkpoint(str(tmp_path / "jax.ckpt"), ours)
    for k, v in other.state_dict().items():
        assert torch.equal(ours.state_dict()[k], v), k


def _port_state(accum, mu_dtype, seed=0):
    torch.manual_seed(seed)
    imagen = TImagen([T.BaseTest(), T.SuperTest()], device="cpu", **IMAGEN_KW)
    opt = ttrain.make_optimizer(1e-3, accum, mu_dtype)
    state = ttrain.create_train_state(imagen, opt, ema=True)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in [*state.params, *state.opt_state.mu, *state.opt_state.nu, *state.ema_params,
                  *(state.opt_state.acc_grads or [])]:
            t.copy_(torch.randn(t.shape, generator=gen))
    state.step, state.opt_state.count = 11, 3
    if accum > 1:
        state.opt_state.mini_step, state.opt_state.gradient_step = 2, 3
    return imagen, opt, state


def _jax_template(imagen, accum, mu_dtype):
    params = {f"unet_{i}": {k: np.zeros(v.shape, np.float32) for k, v in _flat(
        tckpt.flax_unet_tree(u)).items()} for i, u in enumerate(imagen.unets)}
    params = {name: _unflatten(t) for name, t in params.items()}
    tx = jmesh.make_optimizer(1e-3, accum, mu_dtype=jnp.bfloat16 if mu_dtype else None)
    return jmesh.create_train_state(params, tx, ema=True)


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _port_flat(state):
    """The port state's leaves by the JAX state's flattened paths."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float64)
            for k, v in _flat(_to_np(tckpt.train_state_dict(state))).items()}


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("accum,mu_dtype", [(1, None), (1, torch.bfloat16), (3, torch.bfloat16)],
                         ids=["adam-f32", "adam-bf16", "multisteps-bf16"])
def test_train_state_both_ways(tmp_path, accum, mu_dtype):
    """The port's file restores into a JAX TrainState (every leaf equal,
    the bf16 moment as bf16), and the JAX file into the port's state."""
    imagen, opt, state = _port_state(accum, mu_dtype)
    path = str(tmp_path / "port_state.ckpt")
    tckpt.save_train_state(path, state)
    template = _jax_template(imagen, accum, mu_dtype)
    restored = jtrain.load_train_state(path, template)
    want = _port_flat(state)
    got = {k: np.asarray(v, np.float64) for k, v in
           _flat(serialization.to_state_dict(restored)).items() if v is not None}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mu_leaf = jax.tree_util.tree_leaves((restored.opt_state.inner_opt_state if accum > 1
                                         else restored.opt_state)[1][0].mu)[0]
    assert mu_leaf.dtype == (jnp.bfloat16 if mu_dtype else jnp.float32)

    # the other way: a JAX state with other values restores into the port's
    _, _, other = _port_state(accum, mu_dtype, seed=5)
    jstate = jtrain.load_train_state(path, template)
    jtrain.save_train_state(str(tmp_path / "jax_state.ckpt"),
                            jax.tree_util.tree_map(lambda a: a, jstate))
    tckpt.load_train_state(str(tmp_path / "jax_state.ckpt"), other)
    assert other.step == 11 and other.opt_state.count == 3
    for k, v in _port_flat(other).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_train_state_refuses_another_structure(tmp_path):
    _, _, state = _port_state(3, None)
    tckpt.save_train_state(str(tmp_path / "s.ckpt"), state)
    _, _, plain = _port_state(1, None)
    with pytest.raises(ValueError, match="accumulation"):
        tckpt.load_train_state(str(tmp_path / "s.ckpt"), plain)


STEPS = (3, 3)


def _draws(b=2, sizes=(8, 16)):
    rng = np.random.default_rng(4)
    embeds = rng.normal(size=(b, 6, 512)).astype(np.float32)
    mask = np.ones((b, 6), bool)
    mask[1, 4:] = False
    noises = [rng.normal(size=(b, s, s, 3)).astype(np.float32)
              for s in (sizes[0], sizes[1], sizes[1])]
    return embeds, mask, noises


def _jax_cascade(ref):
    """The JAX package's guided DDIM cascade with the port's draw order
    injected: base init, augmentation noise, super-res init."""
    from minimagen_tpu.ops.resize import resize_image_to  # noqa: PLC0415

    embeds, mask, noises = _draws()
    b = embeds.shape[0]
    key = jax.random.PRNGKey(0)
    n0, aug, n1 = (jnp.asarray(a) for a in noises)
    fn0 = ref._build_sample_stage(0, True, "ddim", sample_steps=STEPS[0])
    img0 = fn0(ref.params["unet_0"], key, jnp.asarray(embeds), jnp.asarray(mask),
               jnp.float32(3.0), init_noise=n0)
    times = ref.lowres_noise_schedule.get_times(b, 0.2)
    lowres = ref.lowres_noise_schedule.q_sample(resize_image_to(img0, ref.image_sizes[1]),
                                                times, aug)
    fn1 = ref._build_sample_stage(1, True, "ddim", sample_steps=STEPS[1])
    img1 = fn1(ref.params["unet_1"], key, jnp.asarray(embeds), jnp.asarray(mask),
               jnp.float32(3.0), lowres, times, n1)
    return np.asarray(img0), np.asarray(img1)


def _check_port_cascade(ours, ref_imgs):
    """The port's cascade with the same draws: each stage within 1e-4
    relative L2 of the JAX package's."""
    embeds, mask, noises = _draws()
    it = iter(noises)
    imgs = ours.sample(text_embeds=torch.from_numpy(embeds), text_masks=torch.from_numpy(mask),
                       cond_scale=3.0, sampler="ddim", sample_steps=STEPS, cache_interval=None,
                       noise=lambda shape: torch.from_numpy(next(it)),
                       return_all_stage_outputs=True)
    for img, ref in zip(imgs, ref_imgs):
        rel = np.linalg.norm(img.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 1e-4, rel


def test_training_directories_load_in_either_package(tmp_path, monkeypatch):
    """MinimagenTrain (BaseTest + SuperTest at 8/16px, 2 steps, EMA) writes
    a directory whose state_dicts/ and tmp/ JAX ``load_minimagen`` reads;
    the JAX helpers write its weights into a directory of their own, which
    the port's ``load_minimagen`` reads; the port samples from each what
    JAX samples."""
    monkeypatch.chdir(tmp_path)
    args = ttrain.load_testing_parameters(ttrain.get_minimagen_parser().parse_args([]))
    args.IMG_SIDE_LEN, args.EPOCHS, args.CHCKPT_NUM, args.MAX_NUM_WORDS, args.EMA = 16, 1, 1, 8, 0.9
    torch.manual_seed(0)
    imagen = TImagen([T.BaseTest(), T.SuperTest()], device="cpu", **IMAGEN_KW)
    ds = SyntheticCaptionedImages(num_items=4, side_length=16, encoder_name="t5_small",
                                  max_length=8, device="cpu")
    dl = DataLoader(ds, batch_size=2, shuffle=False, collate_fn=MinimagenCollator(max_length=8))
    training_dir = ttrain.create_directory(str(tmp_path / "training_port"))
    ttrain.save_training_info(args, "port", [c.to_dict() for c in imagen.unet_configs],
                              ttrain.imagen_config_dict(dict(IMAGEN_KW)), 1.0, training_dir)
    summary = ttrain.MinimagenTrain("port", args, imagen.unet_configs, imagen, dl, dl, training_dir)
    assert summary["final_step"] == 2
    run_dir = str(tmp_path / "training_port")
    assert sorted(os.listdir(os.path.join(run_dir, "tmp"))) == [
        "train_state.ckpt", "unet_0_tmp.ckpt", "unet_1_tmp.ckpt"]
    assert sorted(os.listdir(os.path.join(run_dir, "state_dicts"))) == [
        "unet_0_state_port.ckpt", "unet_1_state_port.ckpt"]
    ref = jgen.load_minimagen(run_dir)
    ref_imgs = _jax_cascade(ref)
    _check_port_cascade(tgen.load_minimagen(run_dir, device="cpu"), ref_imgs)

    jargs = jtrain.load_testing_parameters(jtrain.get_minimagen_parser().parse_args([]))
    cm = jtrain.create_directory(str(tmp_path / "training_jax"))
    jtrain.save_training_info(jargs, "jx", [c.to_dict() for c in ref.unet_configs],
                              jtrain.imagen_config_dict(dict(IMAGEN_KW)), 1.0, cm)
    with cm("tmp"):
        for i in range(2):
            jtrain.save_unet_checkpoint(f"unet_{i}_tmp.ckpt", ref.params[f"unet_{i}"])
    _check_port_cascade(tgen.load_minimagen(str(tmp_path / "training_jax"), device="cpu"),
                        ref_imgs)
