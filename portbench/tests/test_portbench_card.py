"""On the card: one short run of a cell through the command line, whose
last line is a correct result on the card's device."""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "lite.ddim50.c64",
                          "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
