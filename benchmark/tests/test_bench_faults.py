"""The comparison fails what it must: the program with its timed path
broken underneath (the harness's look for a card skipped, a tiny cell on
the CPU), and the control, the program's own lower-precision path (the
float32 belief), each give correct false."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, run_tiny
from gcslam_torch.models import runner

CELLS = ["flagship-replay", "kimera-bag", "flagship-live10hz"]


def _state_unchanged(step):
    def f(state, batch, config, *a, **k):
        _, out = step(state, batch, config, *a, **k)
        return state, out
    return f


def _half_the_points(step):
    def f(state, batch, config, *a, **k):
        w = batch.point_weights.clone()
        w[::2] = 0.0
        return step(state, batch._replace(point_weights=w), config, *a, **k)
    return f


def _pose_altered(step):
    def f(state, batch, config, *a, **k):
        new, out = step(state, batch, config, *a, **k)
        return new, out._replace(pose=out.pose + torch.tensor([1e-3, 0, 0, 0, 0, 0], dtype=out.pose.dtype))
    return f


FAULTS = {"state_unchanged": _state_unchanged, "half_the_points": _half_the_points, "pose_altered": _pose_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(cell, fault, cpu_runner, monkeypatch):
    monkeypatch.setattr(runner, "scan_step", FAULTS[fault](runner.scan_step))
    res = run_tiny(cell)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("cell", ["kimera-bag", "flagship-live10hz"])
def test_an_altered_loop_factor_is_not_correct(cell, cpu_runner, monkeypatch):
    """The loop detector's answer altered where it is produced: a factor
    at the pose guess wherever the detector finds none."""
    from gcslam_torch.frontend.loop import LoopDetector

    detect = LoopDetector.detect

    def altered(self, index, pose, points, weights):
        hit = detect(self, index, pose, points, weights)
        return (np.asarray(pose, float), np.eye(6), 0.5) if hit is None else hit

    monkeypatch.setattr(LoopDetector, "detect", altered)
    res = run_tiny(cell)
    assert res["compared"]["loop_mismatch"]["value"] > 0 and res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(cell):
    code = ("import json, sys; sys.path.insert(0, %r); import conftest; conftest.cpu_patches(); "
            "print(json.dumps(conftest.run_tiny(%r)))") % (os.path.dirname(os.path.abspath(__file__)), cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, GCSLAM_BELIEF_DTYPE="float32"), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["compared"]
