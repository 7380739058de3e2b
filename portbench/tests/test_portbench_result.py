"""The result line: the contract's keys and the compared numbers last."""
import json

import pytest

from portbench import run
from portbench.tests import tiny


@pytest.mark.parametrize("cell", ["lite.ddim50.c64", "lite.train.b128"])
def test_result_keys(cell):
    result = tiny.run_tiny(cell, seed=2 ** 31 + 11)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in run.cell_metrics(cell, False)}
    assert set(result["metrics"]) == names - {"peak_mem_gib"} | {"peak_mem_gib"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in result["compared"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(result, allow_nan=False))


def test_no_card_no_result(capsys):
    # this container has no CUDA device: the run fails and prints no line
    assert run.main(["--workload", "lite.ddim50.c64", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
