"""``MinimagenTrain`` on a mesh, on the CPU: a 4-step run over a gloo group
of 2 processes under ZeRO-1 and under FSDP (8 synthetic items, global batch
2, EMA, checkpoints and validation every 2 batches). Process 0 writes the
progress log, the U-Net checkpoints (whole, which the JAX package reads)
and the sharded full-state dump, which a restart on one device resumes
(a restart from the JAX package's Orbax dump: ``test_torch_orbax.py``). And the
train and inference CLIs with ``--MESH data`` over 2 processes joined as
torchrun joins them."""
import glob
import json
import os
import socket

import jax
import numpy as np
import pytest
import torch
import torch_mesh_workers as W

from minimagen_tpu.training import load_unet_checkpoint as jax_load_unet_checkpoint
from minimagen_tpu_torch import checkpoint as tckpt
from minimagen_tpu_torch import generate as tgen
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.models.imagen import to_uint8
from minimagen_tpu_torch.data.collate import DataLoader, MinimagenCollator
from minimagen_tpu_torch.data.dataset import SyntheticCaptionedImages

MODES = ("on", "fsdp")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two MinimagenTrain runs and the CLIs' run (joined through
    torchrun's environment variables), at once."""
    root = tmp_path_factory.mktemp("mesh_runs")
    dirs = {mode: str(root / f"training_{mode}") for mode in MODES}
    jobs = {mode: ("torch_mesh_workers:harness_run", 2, {"run_dir": dirs[mode], "zero1": mode}, {})
            for mode in MODES}
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    jobs["cli"] = ("torch_mesh_workers:cli_run", 2, {"cwd": str(root)},
                   dict(rendezvous="env", env=env))
    jobs["orbax"] = ("torch_mesh_workers:orbax_scenarios", 2, {"dir": str(root / "orbax")}, {})
    results = W.start(jobs)()
    return {mode: (dirs[mode], results[mode]) for mode in MODES} | {
        "cli": (str(root), results["cli"]), "orbax": (str(root / "orbax"), results["orbax"])}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _args(**over):
    args = ttrain.load_testing_parameters(ttrain.get_minimagen_parser().parse_args([]))
    args.IMG_SIDE_LEN, args.EPOCHS, args.CHCKPT_NUM, args.MAX_NUM_WORDS = 16, 1, 2, 8
    args.__dict__.update(over)
    return args


def _loader(**kw):
    ds = SyntheticCaptionedImages(num_items=8, side_length=16, encoder_name="t5_small",
                                  max_length=8, device="cpu")
    return DataLoader(ds, batch_size=2, collate_fn=MinimagenCollator(max_length=8), **kw)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_run_trains_validates_and_writes_from_process_0(runs, mode):
    run_dir, ranks = runs[mode]
    for r in ranks:
        s = r["summary"]
        assert s["final_step"] == s["adam_count"] == 4
        assert [h["batch"] for h in s["history"]] == [0, 2]
        assert all(np.isfinite(h["train"]).all() and np.isfinite(h["valid"]).all()
                   for h in s["history"])
    # every process saw the same whole-batch losses and ends with the same weights
    losses = [[{k: v for k, v in h.items() if k != "steps_per_sec"} for h in r["summary"]["history"]]
              for r in ranks]
    assert losses[0] == losses[1]
    for name, w in ranks[0]["weights"]["unet_1"].items():
        np.testing.assert_array_equal(w, ranks[1]["weights"]["unet_1"][name])
    log = open(os.path.join(run_dir, "training_progess.txt")).read()
    assert log.count("Checkpoint created at batch number") == 2
    assert "Avg Valid Losses" in log and "ABORTED" not in log and "SKIPPED" not in log
    assert sorted(os.listdir(os.path.join(run_dir, "state_dicts")))[0].startswith("unet_0_state_run")
    root = os.path.join(run_dir, "tmp", ttrain.SHARDED_STATE_DIR)
    (dump,) = os.listdir(root)  # each save a new dump, the older ones removed after it
    dump = os.path.join(root, dump)
    assert sorted(os.listdir(dump)) == ["manifest.json", "rank_00000.ckpt", "rank_00001.ckpt"]
    manifest = json.load(open(os.path.join(dump, "manifest.json")))
    assert manifest["world_size"] == 2 and manifest["step"] == 4
    assert any(leaf["axis"] is not None for leaf in manifest["leaves"])


@pytest.mark.parametrize("mode", MODES)
def test_the_jax_package_reads_the_mesh_runs_unet_checkpoint(runs, mode):
    run_dir, ranks = runs[mode]
    imagen = W.cascade_imagen()
    for i in range(2):
        template = jax.tree_util.tree_map(lambda t: t.numpy(),
                                          tckpt.flax_unet_tree(imagen.unets[i]))
        tree = jax_load_unet_checkpoint(os.path.join(run_dir, "tmp", f"unet_{i}_tmp.ckpt"),
                                        template)
        got = tckpt.unet_state_dict(jax.tree_util.tree_map(np.asarray, tree))
        want = ranks[0]["weights"][f"unet_{i}"]  # the final EMA, which the instance keeps
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w)


@pytest.mark.parametrize("mode", MODES)
def test_the_sharded_dump_restores_on_one_device(runs, mode):
    run_dir, ranks = runs[mode]
    imagen = W.cascade_imagen()
    state = ttrain.create_train_state(imagen, ttrain.make_optimizer(1e-4), ema=True)
    ttrain.load_dump(os.path.join(run_dir, "tmp", ttrain.SHARDED_STATE_DIR), state)
    assert state.step == state.opt_state.count == 4
    ema = {(i, n): t for (i, n), t in zip(state.names, state.ema_params)}
    for i in range(2):
        for name, w in ranks[0]["weights"][f"unet_{i}"].items():
            np.testing.assert_array_equal(ema[(i, name)].numpy(), w)
    # the raw parameters come back too: moved from the init, and not the EMA
    init = W.cascade_imagen()
    moved = [not torch.equal(p.detach(), q) for p, q in
             zip(state.params, (q.detach() for q in init.unets.parameters()))]
    assert sum(moved) > len(moved) // 2
    assert not torch.equal(state.params[0].detach(), state.ema_params[0])


def test_a_restart_on_one_device_continues_the_mesh_run(runs, tmp_path, monkeypatch):
    run_dir, _ = runs["on"]
    monkeypatch.chdir(tmp_path)
    args = _args(EMA=0.9, RESTART_DIRECTORY=run_dir)
    imagen = W.cascade_imagen()
    training_dir = ttrain.create_directory(str(tmp_path / "training_restart"))
    summary = ttrain.MinimagenTrain("restart", args, imagen.unet_configs, imagen, _loader(),
                                    _loader(shuffle=False), training_dir)
    assert summary["start_step"] == summary["start_adam_count"] == 4
    assert summary["final_step"] == summary["adam_count"] == 8
    assert os.path.exists(tmp_path / "training_restart" / "tmp" / ttrain.TRAIN_STATE_FILE)


def test_a_mesh_states_orbax_dump_restores_on_one_device_and_on_the_mesh(runs):
    """``save_train_state_orbax`` of a ZeRO-1 state over 2 processes: one
    writer, the state gathered whole; a one-device state and a fresh mesh
    state (each process its blocks) read it back equal."""
    path, ranks = runs["orbax"]
    assert [r["wrote"] for r in ranks] == [True, False]
    opt = ttrain.make_optimizer(1e-3, 1, torch.bfloat16)
    state = ttrain.create_train_state(W.cascade_imagen(), opt, ema=True)
    ttrain.load_train_state_orbax(path, state)
    assert state.step == state.opt_state.count == 1
    saved = ranks[0]["saved"]
    np.testing.assert_array_equal(
        np.concatenate([p.detach().numpy().ravel() for p in state.params]), saved["params"])
    np.testing.assert_array_equal(
        np.concatenate([t.numpy().ravel() for t in state.ema_params]), saved["ema"])
    mu = np.concatenate([t.float().numpy().ravel() for t in state.opt_state.mu])
    for r in ranks:
        assert r["step"] == r["count"] == 1
        np.testing.assert_array_equal(r["mu"], mu)
        for k in ("params", "ema"):
            np.testing.assert_array_equal(r["loaded"][k], saved[k])


def test_the_clis_train_and_sample_on_a_mesh(runs):
    """``train -test --MESH data`` and ``inference --MESH data`` over two
    processes: one directory (process 0 writes it) with the sharded dump;
    the caption padded to two rows, one per process, and the PNG the
    one-device sample of the padded batch."""
    root, ranks = runs["cli"]
    for r in ranks:
        assert r["summary"]["final_step"] == r["summary"]["adam_count"] > 0
    assert ranks[0]["summary"]["history"][0]["valid"] == ranks[1]["summary"]["history"][0]["valid"]
    (run,) = glob.glob(os.path.join(root, "training_mesh*"))
    (dump,) = glob.glob(os.path.join(run, "tmp", ttrain.SHARDED_STATE_DIR, "dump_*"))
    assert sorted(os.listdir(dump)) == ["manifest.json", "rank_00000.ckpt", "rank_00001.ckpt"]
    assert len(glob.glob(os.path.join(run, "parameters", "training_parameters_*.txt"))) == 1
    (out,) = glob.glob(os.path.join(root, "generated_images_*"))
    assert os.listdir(os.path.join(out, "generated_images")) == ["image_0.png"]
    np.testing.assert_array_equal(ranks[0]["pixels"], ranks[1]["pixels"])
    imagen = tgen.load_minimagen(run, device="cpu")
    padded = imagen.sample(texts=["a red square"] * 2, cond_scale=3.0, sampler="ddim",
                           sample_steps=4, generator=torch.Generator().manual_seed(3))
    want = to_uint8(padded.numpy())[:1]
    assert ranks[0]["pixels"].shape == want.shape == (1, 128, 128, 3)
    assert np.abs(ranks[0]["pixels"].astype(int) - want).max() <= 1

