"""The port's training-harness helpers against the JAX package's
(``minimagen_tpu/training.py:93-296``) on the CPU: the parser's flags and
defaults (``vars`` equal), restart and test parameters, the training
directory's layout, the files ``save_training_info`` writes (byte for
byte), the Imagen config dict and ``get_model_size`` of the reference's
test cascade (equal)."""
import os

import jax
import pytest
import torch

from minimagen_tpu import training as jtrain
from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.models import unet as T
from minimagen_tpu_torch.models.imagen import Imagen as TImagen

ARGV = [[], ["-b", "8", "-s", "64", "-test"], ["--EMA", "0.999", "-vn", "15", "-cn", "10",
                                              "-rd", "old", "-p", "params", "-ai", "3"]]


@pytest.mark.parametrize("argv", ARGV, ids=["defaults", "short", "long"])
def test_parser_matches_jax(argv):
    ours = vars(ttrain.get_minimagen_parser().parse_args(argv))
    ref = vars(jtrain.get_minimagen_parser().parse_args(argv))
    assert ours == ref and list(ours) == list(ref)
    assert len(ours) == 16


def test_testing_and_restart_parameters_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ours = ttrain.load_testing_parameters(ttrain.get_minimagen_parser().parse_args([]))
    ref = jtrain.load_testing_parameters(jtrain.get_minimagen_parser().parse_args([]))
    assert vars(ours) == vars(ref)
    cm = ttrain.create_directory(str(tmp_path / "old_run"))
    args = ttrain.get_minimagen_parser().parse_args([])
    args.MAX_NUM_WORDS, args.IMG_SIDE_LEN, args.T5_NAME, args.TIMESTEPS = 48, 96, "t5_small", 123
    args.BATCH_SIZE = 7  # not restored
    ttrain.save_training_info(args, "ts", [], {}, 0.0, cm)
    for mod in (ttrain, jtrain):
        new = mod.get_minimagen_parser().parse_args(["-rd", str(tmp_path / "old_run")])
        new = mod.load_restart_training_parameters(new)
        assert (new.MAX_NUM_WORDS, new.IMG_SIDE_LEN, new.T5_NAME, new.TIMESTEPS, new.BATCH_SIZE) \
            == (48, 96, "t5_small", 123, 2)
        new = mod.get_minimagen_parser().parse_args(["-p", str(tmp_path / "old_run" / "parameters")])
        assert mod.load_restart_training_parameters(new, justparams=True).TIMESTEPS == 123


def test_directory_layout_and_chdir(tmp_path):
    cwd = os.getcwd()
    for mod, name in ((ttrain, "ours"), (jtrain, "ref")):
        cm = mod.create_directory(str(tmp_path / name))
        with cm("tmp"):
            assert os.getcwd() == str(tmp_path / name / "tmp")
            open("probe", "w").close()
        assert os.getcwd() == cwd
    for name in ("ours", "ref"):
        assert sorted(os.listdir(tmp_path / name)) == ["parameters", "state_dicts", "tmp"]


def _imagen_kwargs():
    return dict(image_sizes=(64, 128), timesteps=25, cond_drop_prob=0.15,
                text_encoder_name="t5_small")


def test_save_training_info_writes_the_jax_files(tmp_path, monkeypatch):
    """Flags txt, progress log and both JSON configs are byte-equal; the
    Imagen JSON builds the port's Imagen (and the JAX one)."""
    monkeypatch.chdir(tmp_path)
    for mod, unet_mod, name in ((ttrain, T, "ours"), (jtrain, J, "ref")):
        args = mod.load_testing_parameters(mod.get_minimagen_parser().parse_args(["-rd", "x"]))
        cm = mod.create_directory(str(tmp_path / name))
        unets = [mod.get_default_args(unet_mod.BaseTest), mod.get_default_args(unet_mod.SuperTest)]
        unets = [unet_mod.UnetConfig.from_dict(u).cast_model_parameters(
            lowres_cond=i > 0, text_embed_dim=512, channels=3, channels_out=3).to_dict()
            for i, u in enumerate(unets)]
        mod.save_training_info(args, "ts", unets, mod.imagen_config_dict(_imagen_kwargs()), 1.234, cm)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ref")
                   for d, _, fs in os.walk(tmp_path / "ref") for f in fs)
    assert files == ["parameters/imagen_params_ts.json", "parameters/training_parameters_ts.txt",
                     "parameters/unet_0_params_ts.json", "parameters/unet_1_params_ts.json",
                     "training_progess.txt"]
    for f in files:
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
    unets, imagen_params = ttrain.get_model_params(str(tmp_path / "ours" / "parameters"))
    im = TImagen(unets=[T.UnetConfig.from_dict(u) for u in unets], device="cpu",
                 **{k: v for k, v in imagen_params.items() if k != "unets"})
    assert im.image_sizes == (64, 128) and im.only_train_unet_number is None


def _jax_param_shapes(ref):
    """The JAX cascade's parameter tree as shapes (``jax.eval_shape`` of the
    inits ``Imagen.init_params`` runs: the same tree, nothing computed)."""
    import jax.numpy as jnp  # noqa: PLC0415

    params = {}
    for i, (model, cfg, size) in enumerate(zip(ref.unets, ref.unet_configs, ref.image_sizes)):
        x = jnp.zeros((2, size, size, 3))
        t = jnp.zeros((2,), jnp.int32)
        kw = dict(text_embeds=jnp.zeros((2, 8, ref.text_embed_dim)),
                  text_mask=jnp.ones((2, 8), bool))
        if cfg.lowres_cond:
            kw.update(lowres_cond_img=x, lowres_noise_times=t)
        params[f"unet_{i}"] = jax.eval_shape(
            lambda m=model, x=x, t=t, kw=kw: m.init(jax.random.PRNGKey(0), x, t, **kw))["params"]
    return params


def test_model_size_matches_jax():
    """MB of parameters and schedule buffers of BaseTest + SuperTest."""
    kw = _imagen_kwargs()
    ref = JImagen(unets=[J.BaseTest(), J.SuperTest()], **kw)
    ref.params = _jax_param_shapes(ref)
    ours = TImagen(unets=[T.BaseTest(), T.SuperTest()], device="cpu", dtype=torch.bfloat16,
                   param_dtype=torch.float32, **kw)
    assert ttrain.get_model_size(ours) == jtrain.get_model_size(ref)
