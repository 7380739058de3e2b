"""The port's tools against the JAX package's, on the CPU:

- ``tools/torch_import.py``: synthetic reference U-Net state_dicts (every
  key of the JAX module's ``_reference_key_list``, seeded values, the
  scale-only LayerNorms' zero ``beta`` buffers) converted by the port equal,
  bit for bit, the JAX importer's trees carried over by
  ``checkpoint.unet_state_dict``; the export equals the JAX exporter's and
  then importing gives the same bits; the ``import`` / ``export`` CLI on a
  reference directory written with ``torch.save``, whose imported
  checkpoints the JAX package reads, and ``load_minimagen`` of the
  reference directory itself;
- ``Imagen.stage_memory_analysis``: the argument and output bytes of both
  stages of a cascade equal the JAX package's (the same dtypes and shapes;
  no temporary bytes off the card);
- ``utils/profiling``: a trace written and read back, no device time on the
  CPU, the annotation in the trace, the kernel families;
- the import-path shims: each exports the JAX shim's names, and the names
  the port added behave as the JAX package's do."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_mesh_workers as W

from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.tools import torch_import as jimport
from minimagen_tpu.training import load_unet_checkpoint as jax_load_unet_checkpoint
from minimagen_tpu_torch import generate as tgen
from minimagen_tpu_torch.checkpoint import flax_unet_tree, unet_state_dict
from minimagen_tpu_torch.models.unet import UnetConfig, UnetModel
from minimagen_tpu_torch.tools import torch_import as timport
from minimagen_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the test cascade's stages, and a U-Net with every optional part: attention
# and cross-attention layers and the middle attention
ATTN = UnetConfig(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, layer_attns=(False, True),
                  layer_cross_attns=(False, True), attend_at_middle=True, attn_heads=2)
CONFIGS = {"base test": W.cascade_imagen().unet_configs[0],
           "super test": W.cascade_imagen().unet_configs[1], "attention": ATTN}


def _jax_config(cfg):
    return J.UnetConfig(**{k: getattr(cfg, k) for k in cfg._JSON_KEYS})


def _reference_state_dict(cfg, seed=0):
    """A synthetic reference state_dict of `cfg`: the keys of the JAX
    module's list and the zero beta buffers, shapes from a port U-Net's
    export, values drawn from `seed`."""
    shapes = timport.export_unet_state_dict(UnetModel(cfg).state_dict(), cfg)
    keys = jimport._reference_key_list(_jax_config(cfg))
    assert set(shapes) == set(keys) | {k[:-5] + "beta" for k in keys if k.endswith(".gamma")}
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.zeros_like(v) if k.endswith(".beta") else torch.randn(v.shape, generator=gen)
            for k, v in shapes.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_importer_is_the_jax_importer(name):
    cfg = CONFIGS[name]
    sd = _reference_state_dict(cfg)
    ours = timport.convert_unet_state_dict(sd, cfg)
    jax_tree = jimport.convert_unet_state_dict({k: v.numpy() for k, v in sd.items()},
                                               _jax_config(cfg))
    theirs = unet_state_dict(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert set(ours) == set(theirs) == set(UnetModel(cfg).state_dict())
    for k, v in ours.items():
        assert torch.equal(v, theirs[k]), k
    UnetModel(cfg).load_state_dict(ours, strict=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_is_the_jax_exporter_and_import_gives_the_same_bits(name):
    cfg = CONFIGS[name]
    state = UnetModel(cfg).state_dict()
    ours = timport.export_unet_state_dict(state, cfg)
    theirs = jimport.export_unet_state_dict(
        jax.tree_util.tree_map(lambda t: t.numpy(), flax_unet_tree(state)), _jax_config(cfg))
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    back = timport.convert_unet_state_dict(ours, cfg)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    sd = _reference_state_dict(cfg, seed=1)
    again = timport.export_unet_state_dict(timport.convert_unet_state_dict(sd, cfg), cfg)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """A reference training directory of the test cascade: its parameters
    JSON files and each U-Net's synthetic state_dict saved with torch.save."""
    root = tmp_path_factory.mktemp("reference")
    run = root / "training_ref"
    for sub in ("parameters", "state_dicts", "tmp"):
        (run / sub).mkdir(parents=True)
    imagen = W.cascade_imagen()
    for i, cfg in enumerate(imagen.unet_configs):
        (run / "parameters" / f"unet_{i}_params_ts.json").write_text(json.dumps(cfg.to_dict()))
        torch.save(_reference_state_dict(cfg, seed=10 + i),
                   run / "state_dicts" / f"unet_{i}_state_ts.pth")
    (run / "parameters" / "imagen_params_ts.json").write_text(json.dumps(
        {"image_sizes": [8, 16], "timesteps": 25, "cond_drop_prob": 0.15,
         "text_encoder_name": "t5_small"}))
    return root


def test_the_cli_imports_and_exports_a_reference_directory(reference_dir):
    src, dst, out = (str(reference_dir / d) for d in ("training_ref", "imported", "exported"))
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-m", "minimagen_tpu_torch.tools.torch_import",
                           "import", src, dst], capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "imported 2 unets" in done.stdout
    assert sorted(os.listdir(os.path.join(dst, "parameters"))) == sorted(
        os.listdir(os.path.join(src, "parameters")))
    converted = timport.convert_reference_training_dir(src, device="cpu")
    loaded = tgen.load_minimagen(dst, device="cpu")
    direct = tgen.load_minimagen(src, device="cpu")  # the .pth files converted on load
    for i in range(2):
        want = converted.unets[i].state_dict()
        path = os.path.join(dst, "state_dicts", f"unet_{i}_state_imported.ckpt")
        template = jax.tree_util.tree_map(lambda t: t.numpy(),
                                          flax_unet_tree(converted.unets[i]))
        read = unet_state_dict(jax.tree_util.tree_map(
            np.asarray, jax_load_unet_checkpoint(path, template)))
        for sd in (read, loaded.unets[i].state_dict(), direct.unets[i].state_dict()):
            assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)
    timport.main(["export", dst, out])
    for i in range(2):
        got = torch.load(os.path.join(out, f"unet_{i}_state_exported.pth"), weights_only=True)
        ref = torch.load(os.path.join(src, "state_dicts", f"unet_{i}_state_ts.pth"),
                         weights_only=True)
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_stage_memory_analysis_counts_the_jax_packages_bytes():
    ours = W.cascade_imagen()
    ref = JImagen(unets=[J.BaseTest(), J.SuperTest()], **W.IMAGEN_KW)
    ref.params = {f"unet_{i}": jax.tree_util.tree_map(lambda t: t.numpy(), flax_unet_tree(u))
                  for i, u in enumerate(ours.unets)}
    for stage in range(2):
        kw = dict(batch_size=2, text_len=4, sample_steps=3)
        got = ours.stage_memory_analysis(stage, **kw)
        want = ref.stage_memory_analysis(stage, **kw)
        assert set(got) == {"argument_size_in_bytes", "output_size_in_bytes"}  # no card here
        for field, n in got.items():
            assert n == want[field], (stage, field)
    params = {n: p.detach().half() for n, p in ours.unets[0].named_parameters()}
    half = ours.stage_memory_analysis(0, batch_size=2, text_len=4, params=params)
    full = ours.stage_memory_analysis(0, batch_size=2, text_len=4)
    n = sum(p.numel() for p in ours.unets[0].parameters())
    assert full["argument_size_in_bytes"] - half["argument_size_in_bytes"] == 2 * n


def test_profiling_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("marked range"):
            torch.ones(64).mul(2).sum()
    path = profiling.find_trace(logdir)
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "marked range" for e in events)
    busy, copies, top, cats = profiling.summarize_trace(path)
    assert (busy, copies, top, cats) == (0, 0.0, [], [])  # no device kernels on the CPU
    assert profiling.traced_device_seconds(lambda: torch.ones(4) * 2) is None
    with pytest.raises(FileNotFoundError):
        profiling.find_trace(str(tmp_path / "none"))
    names = {"mqa_fwd_wgmma_kernel": "mqa (wgmma)", "mha_bwd_kernel": "mha (wgmma)",
             "attention_backward_f32": "attention_ (float32; older trees' mma.sync)",
             "kv_reduce_kernel": "kv_reduce", "gn_apply_kernel": "group_norm",
             "depth_to_space_bias_kernel": "depth_to_space",
             "sm90_xmma_gemm_bf16bf16_bf16f32": "convolution/gemm",
             "void cudnn::ops::nchwToNhwcKernel": "copies",
             "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda":
                 "casts",
             "void at::native::(anonymous namespace)::CatArrayBatchedCopy": "copies",
             "void at::native::reduce_kernel<512, 1>": "reductions",
             "void at::native::vectorized_elementwise_kernel<4, AddFunctor>": "elementwise",
             "something else": "other"}
    for name, family in names.items():
        assert profiling.op_category(name) == family, name
    ms = profiling.family_ms([("gn_apply_kernel", 1000.0), ("mha_fwd", 500.0),
                              ("gn_stats_kernel", 1000.0)], calls=2)
    assert tuple(ms) == profiling.FAMILY_ORDER
    assert ms["group_norm"] == 1.0 and ms["mha (wgmma)"] == 0.25 and ms["other"] == 0.0


SHIMS = ("Imagen", "Unet", "t5", "diffusion_model", "helpers", "layers")


@pytest.mark.parametrize("shim", SHIMS)
def test_each_shim_exports_the_jax_shims_names(shim):
    import importlib

    ours = importlib.import_module(f"minimagen_tpu_torch.{shim}")
    theirs = importlib.import_module(f"minimagen_tpu.{shim}")
    public = lambda m: {n for n in vars(m) if not n.startswith("_")}  # noqa: E731
    assert public(ours) == public(theirs)
    import minimagen_tpu_torch

    assert getattr(minimagen_tpu_torch, shim) is ours


def test_the_names_the_shims_added_behave_as_the_jax_packages():
    import jax.numpy as jnp

    import minimagen_tpu.diffusion_model as jdiff
    import minimagen_tpu.helpers as jh
    import minimagen_tpu.t5 as jt5
    from minimagen_tpu_torch import diffusion_model, helpers, t5
    from minimagen_tpu_torch.Unet import Base, Unet

    assert Unet is UnetConfig and Base().dim == 512
    x = np.array([0.0, 1e-20, 0.5, 3.0], np.float32)
    np.testing.assert_allclose(helpers.log(torch.from_numpy(x)).numpy(),
                               np.asarray(jh.log(jnp.asarray(x))), rtol=1e-6)
    assert helpers.identity(3, 1, a=2) == jh.identity(3, 1, a=2) == 3
    double = helpers.maybe(lambda v: v * 2)
    assert double(None) is None and double(2) == jh.maybe(lambda v: v * 2)(2) == 4
    ours, theirs = diffusion_model.create_gaussian_diffusion(50, "cpu"), jdiff.create_gaussian_diffusion(50)
    for name in ("betas", "alphas_cumprod", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)))
    assert t5.DEFAULT_T5_NAME == jt5.DEFAULT_T5_NAME
    enc, mask = t5.t5_encode_text(["a red square", "a dog"], name="t5_tiny", device="cpu")
    want = t5.t5_encode_text(["a red square", "a dog"], name="t5_tiny", device="cpu")
    assert enc.shape[:2] == mask.shape and enc.shape[-1] == 64 and mask.dtype == torch.bool
    assert torch.equal(enc, want[0])
    with pytest.warns(UserWarning, match="hash text encoder"):
        enc, mask = t5.t5_encode_text(["a red square"], name="t5_large", device="cpu")
    jenc, jmask = jt5.t5_encode_text(["a red square"], name="t5_large")
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_allclose(enc.numpy(), jenc, rtol=1e-6)
