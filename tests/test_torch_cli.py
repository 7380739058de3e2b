"""The port's CLIs on the CPU (``--DEVICE cpu``): ``python -m
minimagen_tpu_torch.main`` trains the reference's test cascade and samples
a PNG, as the root ``main.py`` does; the inference CLI's PNGs decode (with
PIL, here) to the pixels it returns, which are ``Imagen.sample``'s from the
same weights and seed rounded to uint8; the train CLI restarts from the
directory at its dumped step; ``--MESH data`` on a missing CUDA device
raises instead of falling back to the CPU."""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from minimagen_tpu_torch import generate as tgen
from minimagen_tpu_torch import inference as tinf
from minimagen_tpu_torch import train as ttrain_cli
from minimagen_tpu_torch.models.imagen import to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    """The demo CLI's working directory after one run."""
    cwd = tmp_path_factory.mktemp("demo")
    # HF_DATASETS_OFFLINE: the train CLI's ConceptualCaptions takes the
    # offline set at once instead of first trying the hub where `datasets`
    # is installed
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", HF_DATASETS_OFFLINE="1")
    subprocess.run([sys.executable, "-m", "minimagen_tpu_torch.main", "--DEVICE", "cpu"],
                   cwd=cwd, env=env, check=True, timeout=600, capture_output=True)
    return cwd


def test_demo_trains_and_writes_a_png(demo_dir):
    (run,) = glob.glob(str(demo_dir / "training_*"))
    assert sorted(os.listdir(os.path.join(run, "tmp"))) == [
        "train_state.ckpt", "unet_0_tmp.ckpt", "unet_1_tmp.ckpt"]
    assert "Checkpoint created at batch number 0" in open(os.path.join(run, "training_progess.txt")).read()
    (png,) = glob.glob(str(demo_dir / "generated_images_*" / "generated_images" / "image_0.png"))
    img = np.asarray(Image.open(png))
    assert img.shape == (128, 128, 3) and img.dtype == np.uint8


def test_inference_cli_pixels_are_the_samples(demo_dir, monkeypatch):
    monkeypatch.chdir(demo_dir)
    (run,) = glob.glob("training_*")
    argv = ["-d", run, "-c", "a red square", "--SAMPLER", "ddim", "--SAMPLE_STEPS", "4",
            "--SEED", "3", "--DEVICE", "cpu"]
    before = set(glob.glob("generated_images_*"))
    pixels = tinf.main(argv)
    (out,) = set(glob.glob("generated_images_*")) - before
    png = np.asarray(Image.open(os.path.join(out, "generated_images", "image_0.png")))
    np.testing.assert_array_equal(png, pixels[0])
    imagen = tgen.load_minimagen(run, device="cpu")
    direct = imagen.sample(texts=["a red square"], cond_scale=3.0, sampler="ddim", sample_steps=4,
                           generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(to_uint8(direct.numpy()), pixels)


def _offline_datasets(monkeypatch):
    """A ``datasets`` module whose ``load_dataset`` raises, as without a
    network: the train CLI takes the offline set at once."""
    import types

    mod = types.ModuleType("datasets")

    def load_dataset(name):
        raise ConnectionError("offline")

    mod.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", mod)


def test_train_cli_restarts_at_the_dumped_step(demo_dir, monkeypatch, capsys):
    _offline_datasets(monkeypatch)
    monkeypatch.chdir(demo_dir)
    (run,) = glob.glob("training_*")
    summary = ttrain_cli.main(["-test", "-rd", run, "-ts", "restart", "-e", "1", "--DEVICE", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["summary"]["final_step"] == summary["final_step"]
    # load_testing_parameters sets EPOCHS 2 after -e, as in the reference: 8
    # batches, less any the 30 s watchdog skipped on a loaded machine
    assert summary["start_step"] == summary["start_adam_count"] == 8
    log = open(os.path.join("training_restart", "training_progess.txt")).read()
    assert summary["final_step"] == summary["adam_count"] == 16 - log.count("SKIPPED")
    assert os.path.exists(os.path.join("training_restart", "tmp", "train_state.ckpt"))
    assert log.startswith(f"STARTED FROM CHECKPOINT {run}")


def test_one_device_clis_refuse_a_mesh():
    """``--MESH data`` on a CUDA device this machine lacks raises before any
    work (a mesh never falls back to the CPU) and joins no process group;
    the sharding flags parse."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: --MESH data would train on it")
    with pytest.raises(RuntimeError, match="does not fall back"):
        ttrain_cli.main(["--MESH", "data", "--DEVICE", "cuda"])
    with pytest.raises(RuntimeError, match="does not fall back"):
        tinf.main(["-d", "x", "--MESH", "data", "--DEVICE", "cuda"])
    assert not torch.distributed.is_initialized()
    args = ttrain_cli.build_parser().parse_args(["--ZERO1", "fsdp", "--MU_DTYPE", "bf16"])
    assert (args.ZERO1, args.MU_DTYPE, args.DEVICE) == ("fsdp", "bf16", "cuda")
