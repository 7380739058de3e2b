"""End to end through the port's harness on the CPU (the counterpart of
``tests/test_e2e.py``, at 8->16px): a tiny train writes checkpoints, which
reload and sample into PNGs; a failing loader gets a crash dump and the
next epoch runs; the watchdog skips a hung batch; an update that fails
halfway puts back the last dump, and the watchdog waits for an update to
end; a restart resumes the dumped step with Adam's moments and count."""
import os
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from minimagen_tpu_torch import checkpoint as tckpt
from minimagen_tpu_torch import generate as tgen
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.data.collate import DataLoader, MinimagenCollator
from minimagen_tpu_torch.data.dataset import SyntheticCaptionedImages
from minimagen_tpu_torch.models.imagen import Imagen
from minimagen_tpu_torch.models.unet import BaseTest, SuperTest

IMAGEN_KW = dict(timesteps=25, cond_drop_prob=0.15, text_encoder_name="t5_small")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core, and torch's
    default of one thread per core each slows every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(**over):
    args = ttrain.load_testing_parameters(ttrain.get_minimagen_parser().parse_args([]))
    args.IMG_SIDE_LEN, args.EPOCHS, args.CHCKPT_NUM, args.MAX_NUM_WORDS = 16, 1, 2, 8
    args.__dict__.update(over)
    return args


def _loader(ds, **kw):
    return DataLoader(ds, batch_size=2, collate_fn=MinimagenCollator(max_length=8), **kw)


def _synthetic(n=8, cls=SyntheticCaptionedImages):
    return cls(num_items=n, side_length=16, encoder_name="t5_small", max_length=8, device="cpu")


def _cascade(unets=(BaseTest, SuperTest), sizes=(8, 16)):
    torch.manual_seed(0)
    return Imagen(unets=[u() for u in unets], image_sizes=sizes, device="cpu", **IMAGEN_KW)


def test_tiny_train_checkpoint_reload_sample(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _args(EMA=0.9)
    imagen = _cascade()
    ds = _synthetic()
    training_dir = ttrain.create_directory(str(tmp_path / "training_run"))
    ttrain.save_training_info(args, "run", [c.to_dict() for c in imagen.unet_configs],
                              ttrain.imagen_config_dict(dict(image_sizes=[8, 16], **IMAGEN_KW)),
                              1.0, training_dir)
    summary = ttrain.MinimagenTrain("run", args, imagen.unet_configs, imagen, _loader(ds),
                                    _loader(ds, shuffle=False), training_dir)
    assert summary["final_step"] == 4 and summary["adam_count"] == 4
    assert [h["batch"] for h in summary["history"]] == [0, 2]
    assert all(np.isfinite(h["train"]).all() and np.isfinite(h["valid"]).all()
               for h in summary["history"])
    run_dir = tmp_path / "training_run"
    assert sorted(os.listdir(run_dir / "state_dicts"))[0].startswith("unet_0_state_run")
    log = (run_dir / "training_progess.txt").read_text()
    assert "Checkpoint created at batch number 0" in log and "Avg Valid Losses" in log
    assert "Train steps/sec" in log

    # the tmp/ dump holds the final EMA weights, which the instance now has
    tmp_unet = tckpt.unet_state_dict(tckpt.read_msgpack(str(run_dir / "tmp" / "unet_1_tmp.ckpt")))
    for k, v in imagen.unets[1].state_dict().items():
        assert torch.equal(tmp_unet[k], v), k
    reloaded = tgen.load_minimagen(str(run_dir), device="cpu")
    assert reloaded.num_unets == 2

    gen = torch.Generator().manual_seed(5)
    pixels = tgen.sample_and_save(["a red square"], training_directory=str(run_dir),
                                  sample_args={"cond_scale": 3.0, "sampler": "ddim",
                                               "sample_steps": 3, "generator": gen},
                                  save_directory="gen_out", device="cpu")
    out = tmp_path / "gen_out"
    assert (out / "captions.txt").read_text().strip() == "a red square"
    assert (out / "imagen_training_directory.txt").read_text() == str(run_dir)
    assert pixels.shape == (1, 16, 16, 3) and pixels.dtype == np.uint8
    from PIL import Image  # the tests' machine has PIL; the port does not need it

    np.testing.assert_array_equal(np.asarray(Image.open(out / "generated_images" / "image_0.png")),
                                  pixels[0])
    with pytest.raises(FileExistsError):
        tgen.sample_and_save(["x"], training_directory=str(run_dir), save_directory="gen_out",
                             device="cpu")


def test_training_survives_loader_failure(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    class Exploding(SyntheticCaptionedImages):
        def __getitem__(self, idx):
            if idx == 5:
                raise RuntimeError("synthetic loader explosion")
            return super().__getitem__(idx)

    imagen = _cascade((BaseTest,), (16,))
    training_dir = ttrain.create_directory(str(tmp_path / "training_x"))
    summary = ttrain.MinimagenTrain("x", _args(EPOCHS=2, CHCKPT_NUM=100), imagen.unet_configs,
                                    imagen, _loader(_synthetic(cls=Exploding), shuffle=False,
                                                    prefetch=0),
                                    _loader(_synthetic(4), shuffle=False), training_dir)
    log = (tmp_path / "training_x" / "training_progess.txt").read_text()
    assert "DATA LOADER FAILED" in log and "EPOCH 2" in log
    assert (tmp_path / "training_x" / "tmp" / "unet_0_tmp.ckpt").exists()
    assert summary["final_step"] == 4  # two good batches in each epoch


def test_collator_none_batches_are_skipped(tmp_path, monkeypatch):
    """Items that fail come back None; a batch of which nothing is left is
    skipped, the rest train."""
    monkeypatch.chdir(tmp_path)
    ds = SyntheticCaptionedImages(num_items=8, side_length=16, encoder_name="t5_small",
                                  max_length=8, failure_rate=0.5, device="cpu")
    batches = list(_loader(ds, shuffle=False))
    imagen = _cascade((BaseTest,), (16,))
    training_dir = ttrain.create_directory(str(tmp_path / "training_n"))
    summary = ttrain.MinimagenTrain("n", _args(CHCKPT_NUM=100), imagen.unet_configs, imagen,
                                    _loader(ds, shuffle=False), _loader(_synthetic(4)),
                                    training_dir)
    assert summary["final_step"] == sum(b is not None for b in batches) < len(batches)


def test_training_watchdog_skips_hung_batch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    real_make = ttrain.make_train_step
    calls = {"n": 0}

    def hanging_make_train_step(imagen_arg, optimizer, **kw):
        real_step = real_make(imagen_arg, optimizer, **kw)

        def step(state, batch, seed=0):
            calls["n"] += 1
            if calls["n"] == 2:  # the epoch's first batch is exempt
                time.sleep(3.0)
            return real_step(state, batch, seed)

        return step

    monkeypatch.setattr(ttrain, "make_train_step", hanging_make_train_step)
    imagen = _cascade((BaseTest,), (16,))
    training_dir = ttrain.create_directory(str(tmp_path / "training_wd"))
    summary = ttrain.MinimagenTrain("wd", _args(CHCKPT_NUM=100), imagen.unet_configs, imagen,
                                    _loader(_synthetic(), shuffle=False, prefetch=0),
                                    _loader(_synthetic(4)), training_dir, timeout=1)
    log = (tmp_path / "training_wd" / "training_progess.txt").read_text()
    assert "BATCH 1 EPOCH 0 SKIPPED" in log and "watchdog" in log
    # the other batches trained (a loaded machine may push another past 1 s)
    assert summary["final_step"] == 4 - log.count("SKIPPED") >= 1


def test_an_update_failing_halfway_restores_the_last_dump(tmp_path, monkeypatch):
    """The third update raises after it has advanced Adam's count and nu
    (and before the parameters and mu): training goes on from the dump of
    batch 0 (step 1), not from the torn state, so the count still equals
    the step at the end; without a dump to go back to, the run raises."""
    monkeypatch.chdir(tmp_path)
    real_adam = ttrain.ClippedAdam._adam
    calls = {"n": 0}

    def failing_adam(self, params, grads, state):
        calls["n"] += 1
        if calls["n"] == calls.get("fail"):
            state.count += 1
            torch._foreach_mul_(state.nu, 0.5)
            raise RuntimeError("injected failure inside the update")
        return real_adam(self, params, grads, state)

    monkeypatch.setattr(ttrain.ClippedAdam, "_adam", failing_adam)
    calls["fail"] = 3
    training_dir = ttrain.create_directory(str(tmp_path / "training_t"))
    summary = ttrain.MinimagenTrain("t", _args(EMA=0.9, CHCKPT_NUM=100), None,
                                    _cascade((BaseTest,), (16,)),
                                    _loader(_synthetic(), shuffle=False), _loader(_synthetic(4)),
                                    training_dir)
    log = (tmp_path / "training_t" / "training_progess.txt").read_text()
    assert "injected failure" in log and "STATE RESTORED FROM" in log and "(STEP 1)" in log
    assert summary["final_step"] == summary["adam_count"] == 2
    dumped = tckpt.read_msgpack(str(tmp_path / "training_t" / "tmp" / "train_state.ckpt"))
    assert int(dumped["step"]) == int(dumped["opt_state"]["1"]["0"]["count"]) == 2

    calls.update(n=0, fail=1)  # the first update: nothing dumped yet
    with pytest.raises(RuntimeError, match="no full-state dump"):
        ttrain.MinimagenTrain("u", _args(CHCKPT_NUM=100), None, _cascade((BaseTest,), (16,)),
                              _loader(_synthetic(4), shuffle=False), _loader(_synthetic(4)),
                              ttrain.create_directory(str(tmp_path / "training_u")))


def test_the_watchdog_waits_for_an_update_to_end():
    """An alarm that comes while an update is applied is raised once it has
    ended, with the state whole."""
    state = SimpleNamespace(torn=False)
    finished = []
    with pytest.raises(ttrain.BatchTimeoutError):
        with ttrain._Timeout(60):
            with ttrain.applying_update(state):
                os.kill(os.getpid(), signal.SIGALRM)
                time.sleep(0.05)  # an alarm let through would raise here
                finished.append(state.torn)
    assert finished == [True] and state.torn is False


def test_restart_resumes_the_step_and_moments(tmp_path, monkeypatch):
    """A second run with RESTART_DIRECTORY starts from the first run's
    final dump: its step and Adam count, moments and EMA, and trains on."""
    monkeypatch.chdir(tmp_path)
    args = _args(EMA=0.9, CHCKPT_NUM=100)
    imagen = _cascade()
    first_dir = ttrain.create_directory(str(tmp_path / "training_a"))
    opt = ttrain.make_optimizer(1e-4, mu_dtype=torch.bfloat16)
    first = ttrain.MinimagenTrain("a", args, imagen.unet_configs, imagen, _loader(_synthetic()),
                                  _loader(_synthetic(4)), first_dir, opt)
    assert first["final_step"] == 4
    dumped = tckpt.read_msgpack(str(tmp_path / "training_a" / "tmp" / "train_state.ckpt"))
    mu0 = dumped["opt_state"]["1"]["0"]["mu"]["unet_0"]["final_conv"]["kernel"]

    resumed = {}
    real_create = ttrain.create_train_state

    def spy(*a, **kw):
        state = real_create(*a, **kw)
        resumed["state"] = state
        return state

    monkeypatch.setattr(ttrain, "create_train_state", spy)
    args = _args(EMA=0.9, CHCKPT_NUM=100, RESTART_DIRECTORY=str(tmp_path / "training_a"))
    second_dir = ttrain.create_directory(str(tmp_path / "training_b"))
    second = ttrain.MinimagenTrain("b", args, imagen.unet_configs, _cascade(),
                                   _loader(_synthetic()), _loader(_synthetic(4)), second_dir,
                                   ttrain.make_optimizer(1e-4, mu_dtype=torch.bfloat16))
    assert second["start_step"] == 4 and second["start_adam_count"] == 4
    assert second["final_step"] == 8 and second["adam_count"] == 8
    assert np.asarray(mu0).any()
    state = resumed["state"]
    assert state.opt_state.mu[0].dtype == torch.bfloat16 and state.step == 8
