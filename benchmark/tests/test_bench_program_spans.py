"""The readers of the program's stage clock and host spans on a made-up
run: their arithmetic, and None where the program holds nothing to read
(no compiled step cached, or a program without the clock or the spans)."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from gcslam_torch.utils import profiling
from gcslam_torch.utils.profiling import STAGES, HostSpans, StageReading

NAMES = [f"stage_ms_per_scan.{s}.replay" for s in STAGES] + [
    "step_idle_share.replay", "bag_staging_ms_per_scan.replay", "step_host_ms_per_scan.replay"]


def ctx_of(steps=("a step",), reading=None, runner=None):
    runner = runner or SimpleNamespace(compiled_steps=lambda: list(steps), stage_reading=lambda: reading)
    return {"run": SimpleNamespace(program=SimpleNamespace(runner=runner))}


@pytest.fixture
def spans(monkeypatch):
    s = HostSpans()
    for name, seconds, calls in [("run_bag.start", 0.004, 2), ("run_bag.stack", 0.010, 2),
                                 ("run_bag.to_device", 0.006, 2), ("step.launch", 0.0049, 49),
                                 ("step.outputs", 0.010, 100)]:
        s.seconds[name], s.calls[name] = seconds, calls
    monkeypatch.setattr(profiling, "SPANS", s)
    return s


def read(name, ctx):
    return spec.metric_reader(name)(ctx, name)


def test_the_readers_arithmetic(spans):
    # two steps: 1 ms in each stage but write_state (0.5 ms), 0.25 ms between them in all
    reading = StageReading({s: (500_000 if s == "write_state" else 1_000_000) * 2 for s in STAGES}, 2, 250_000)
    ctx = ctx_of(reading=reading)
    assert [read(f"stage_ms_per_scan.{s}.replay", ctx) for s in STAGES] == [1.0] * 8 + [0.5]
    assert read("step_idle_share.replay", ctx) == pytest.approx(100 * 0.25 / (2 * 8.5 + 0.25))
    assert read("bag_staging_ms_per_scan.replay", ctx) == pytest.approx(1e3 * 0.020 / 100)
    assert read("step_host_ms_per_scan.replay", ctx) == pytest.approx(0.1 + 0.1)


def test_the_readers_find_nothing_to_read(spans, monkeypatch):
    reading = StageReading(dict.fromkeys(STAGES, 1), 1, 0)
    for ctx in (ctx_of(steps=(), reading=None), {"run": SimpleNamespace(program=None)}):
        assert [read(n, ctx) for n in NAMES] == [None] * len(NAMES)
    # the parent's program: a runner without stage_reading, and no SPANS
    old = ctx_of(runner=SimpleNamespace(compiled_steps=lambda: ["a step"]))
    monkeypatch.delattr(profiling, "SPANS")
    assert [read(n, old) for n in NAMES] == [None] * len(NAMES)
    assert read("stage_ms_per_scan.scrub.replay", ctx_of(reading=reading)) == 1e-6


def test_the_stage_entries():
    names = [m["name"] for m in spec.load_spec()["per_layer"]]
    assert set(NAMES) <= set(names)
    cell = spec.load_cell("flagship-replay")
    assert set(NAMES) <= {m["name"] for m in cell.per_layer}
