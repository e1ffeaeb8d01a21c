"""The benchmark on the card, through its command: every cell's run is
correct, and its control (the program's float32-belief path) is not.
Skips where torch sees no CUDA card (decided inside each test)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

pytestmark = pytest.mark.cuda

CELLS = ["flagship-replay"]


def _run(cell: str, seed: int, **env) -> dict:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(seed),
                          "--seconds", "4", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, **env), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(cell):
    res = _run(cell, 2**31 + 101)
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(cell):
    res = _run(cell, 2**31 + 102, GCSLAM_BELIEF_DTYPE="float32")
    assert res["correct"] is False, res["compared"]
