"""The kimera-replay cell on the CPU (tiny cells, the harness's look for a
card skipped), judged by its own limits file (benchmark/limits/
kimera-replay.json): the faults and the control give correct false; and
the readers of run_chunked's host spans, on made-up spans and on a tiny
traced run."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spec
from conftest import ROOT, tiny_cell
from gcslam_torch.models import runner
from gcslam_torch.utils import profiling
from gcslam_torch.utils.profiling import STAGES, HostSpans
from test_bench_faults import FAULTS

CELL = "kimera-replay"
CHUNKED = ["chunked_staging_ms_per_scan.replay", "chunk_boundary_ms_per_scan.replay"]


def run_judged(seconds: float = 1.0, seed: int = 2**31 + 7, trace: bool = False) -> dict:
    """One run of the tiny kimera-replay cell on the CPU through the
    harness, judged by the cell's limits file; returns the result dict."""
    import importlib

    from benchmark import harness

    cell = tiny_cell(CELL)
    run = harness.Run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
    return harness.execute(run, importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}"))


# the pose fault (1 mm, nothing else moved) is left out: on the card a near-tie of the map, resolved the other
# way in one segment, moves a sound run's widest pose gap by up to 5.1e-3 m, so this cell's pose limit sits
# above 1 mm (the limits file's note, PERF.md)
@pytest.mark.parametrize("fault", ["half_the_points", "state_unchanged"])
def test_a_broken_step_is_not_correct(fault, cpu_runner, monkeypatch):
    monkeypatch.setattr(runner, "scan_step", FAULTS[fault](runner.scan_step))
    res = run_judged()
    assert res["correct"] is False, res["compared"]


def test_an_altered_loop_factor_is_not_correct(cpu_runner, monkeypatch):
    """The loop detector's answer altered where it is produced: a factor
    at the pose guess wherever the detector finds none."""
    from gcslam_torch.frontend.loop import LoopDetector

    detect = LoopDetector.detect

    def altered(self, index, pose, points, weights):
        hit = detect(self, index, pose, points, weights)
        return (np.asarray(pose, float), np.eye(6), 0.5) if hit is None else hit

    monkeypatch.setattr(LoopDetector, "detect", altered)
    res = run_judged()
    assert res["compared"]["loop_mismatch"]["value"] > 0 and res["correct"] is False


def test_the_float32_control_is_not_correct():
    code = ("import json, sys; sys.path.insert(0, %r); import conftest; conftest.cpu_patches(); "
            "import test_bench_kimera_replay as t; print(json.dumps(t.run_judged()))"
            ) % os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, GCSLAM_BELIEF_DTYPE="float32"), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["compared"]


def test_a_sound_run_is_correct_by_the_limits_file(cpu_runner):
    """Every number the limits file names is compared, and on the CPU,
    where the reference is the program bit for bit, each reads 0."""
    with open(os.path.join(spec.BENCH_DIR, "limits", CELL + ".json")) as f:
        limits = json.load(f)["limits"]
    res = run_judged()
    assert res["correct"] is True and set(res["compared"]) == set(limits)
    assert all(v["value"] == 0.0 for v in res["compared"].values())


def read(name, ctx):
    return spec.metric_reader(name)(ctx, name)


def ctx_of(steps=("a step",)):
    return {"run": SimpleNamespace(program=SimpleNamespace(runner=SimpleNamespace(compiled_steps=lambda: list(steps))))}


def test_the_readers_arithmetic_and_none(monkeypatch):
    s = HostSpans()
    for name, seconds, calls in [("step.outputs", 0.010, 100), ("run_bag.start", 0.004, 2),
                                 ("run_chunked.start", 0.002, 1), ("run_chunked.stack", 0.003, 1),
                                 ("run_chunked.to_device", 0.001, 1), ("run_chunked.poses", 0.030, 5),
                                 ("run_chunked.loop", 0.020, 5)]:
        s.seconds[name], s.calls[name] = seconds, calls
    monkeypatch.setattr(profiling, "SPANS", s)
    assert read(CHUNKED[0], ctx_of()) == pytest.approx(1e3 * 0.006 / 100)
    assert read(CHUNKED[1], ctx_of()) == pytest.approx(1e3 * 0.050 / 100)
    for ctx in (ctx_of(steps=()), {"run": SimpleNamespace(program=None)}):
        assert [read(n, ctx) for n in CHUNKED] == [None, None]
    # a program whose run_chunked has no spans (the parent's: run_bag's and the step's only)
    for k in [k for k in s.calls if k.startswith("run_chunked.")]:
        del s.calls[k], s.seconds[k]
    assert [read(n, ctx_of()) for n in CHUNKED] == [None, None]
    monkeypatch.delattr(profiling, "SPANS")
    assert [read(n, ctx_of()) for n in CHUNKED] == [None, None]


def test_the_cells_entries():
    """kimera-replay reports the replay metrics of flagship-replay but the
    run_bag staging, and the two run_chunked metrics, which no other cell
    reports."""
    bench = spec.load_spec()
    assert spec.check_names(bench) == []
    flagship = {m["name"] for m in spec.load_cell("flagship-replay").per_layer}
    kimera = {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert kimera == (flagship - {"bag_staging_ms_per_scan.replay"}) | set(CHUNKED)
    assert {f"stage_ms_per_scan.{s}.replay" for s in STAGES} <= kimera
    assert [w["name"] for w in bench["workloads"]] == ["flagship-replay", CELL]
    assert {m["name"] for m in spec.load_cell(CELL).end_to_end} == {"setup_s", "replay_ms_per_scan",
                                                                     "peak_device_mib"}


def test_the_chunked_readers_on_a_tiny_run(cpu_runner, monkeypatch):
    """A tiny traced kimera-replay run on the CPU, its steps through the
    compiled step's body without capture (so that step.outputs counts the
    scans and a compiled step is cached): both run_chunked readers report a
    number in the result's line."""

    class Uncaptured(runner.CompiledStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **dict(kwargs, capture=False))

    init = runner.StepLoop.__init__

    def compiled_loop(self, *args):
        init(self, *args)
        self.use_compiled = True

    monkeypatch.setattr(runner, "CompiledStep", Uncaptured)
    monkeypatch.setattr(runner.StepLoop, "__init__", compiled_loop)
    monkeypatch.setattr(profiling, "SPANS", HostSpans())
    res = run_judged(seconds=2.0, trace=True)
    assert res["correct"] is True, res["compared"]
    assert all(res["metrics"][n]["value"] > 0 for n in CHUNKED), res["metrics"]
