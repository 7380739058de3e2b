"""The comparison fails what it should. The control (the reference with
float8 products in the program's place) comes out not correct against each
cell's limits, and a run with the timed path broken underneath (a step that
leaves its state unchanged, an answer altered where it is made, half of
the batch left out, an EMA left unchanged) comes out not correct. Tiny cascades on the CPU; the
readings at the cells' own sizes were taken on the card
(``python3 -m portbench.calibrate``, PERF.md)."""
import pytest
from portbench import calibrate, faults, run
from portbench.tests import tiny


@pytest.mark.parametrize("cell", ["default.ddim50.c8", "lite.ddim50.c64", "default.train.b16",
                                  "lite.train.b128"])
def test_control_fails(cell):
    w = tiny.tiny_workload(cell)
    ctx = run.make_context(cell, 2024, workload=w, config=tiny.tiny_config(w["config"]),
                           device="cpu")
    fn = calibrate.control_sampling if w["mode"] == "sample" else calibrate.control_training
    with tiny.cpu_cuda():
        gaps = fn(ctx)
    assert any(gaps[k] > lim for k, lim in w["limits"].items()), gaps


@pytest.mark.parametrize("cell,fault", [
    ("default.ddim50.c8", "sample_state_unchanged"),
    ("default.ddim50.c8", "sample_answer_altered"),
    ("lite.ddim50.c64", "sample_state_unchanged"),
    ("lite.ddim50.c64", "sample_answer_altered"),
    ("default.train.b16", "train_state_unchanged"),
    ("default.train.b16", "train_half_batch"),
    ("lite.train.b128", "train_state_unchanged"),
    ("lite.train.b128", "train_half_batch"),
    ("default.train.b16", "train_ema_unchanged"),
    ("lite.train.b128", "train_ema_unchanged"),
])
def test_broken_timed_path_is_not_correct(cell, fault):
    with faults.planted(fault):
        result = tiny.run_tiny(cell, seed=31337)
    assert result["correct"] is False, result["compared"]


def test_sound_tiny_run_is_correct():
    assert tiny.run_tiny("default.ddim50.c8", seed=31337)["correct"] is True
