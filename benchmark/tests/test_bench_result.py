"""The result's last line, from a whole tiny run of each cell on the CPU."""

import json

import pytest

from conftest import run_tiny

CELLS = ["flagship-replay", "kimera-bag", "flagship-live10hz", "kimera-replay"]


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, cpu_runner):
    res = json.loads(json.dumps(run_tiny(cell)))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "compared"
    assert res["correct"] is True and res["attempted"] > 0
    assert {"setup_s", "peak_device_mib"} < set(res["metrics"])
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # on the CPU the program's plain routes are the reference's: every compared number reads 0
    assert res["compared"] and all(v["value"] == 0.0 for v in res["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell, cpu_runner):
    """A --trace 1 run's plumbing on the CPU: the traced stretch is read
    (with no device activity, the device metrics are left out) and the
    host-clock per-layer metrics are reported."""
    res = run_tiny(cell, seconds=2.0, trace=True)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"} and len(res["breakdown"]["idle_gaps"]) <= 10
    assert "capture_s" not in res["metrics"]  # no graph on the CPU
    expected = {"kimera-bag": "decode_ms_per_scan.bag", "flagship-live10hz": "loop_ms_per_scan.live"}
    if cell in expected:
        assert expected[cell] in res["metrics"]
    assert not any(k.startswith(("device_", "sinkhorn", "eigh")) for k in res["metrics"])


def test_the_loop_segment_is_compared(cpu_runner, monkeypatch):
    """In the live cell the first scan that the detector gives a loop
    factor starts a compared segment; the reference, injecting its own
    detector's factor there, reads 0 on the CPU."""
    import numpy as np

    from benchmark.reference import check
    from benchmark.reference.plain.frontend import loop as rloop
    from gcslam_torch.frontend import loop as ploop

    def firing(detect):
        def f(self, index, pose, points, weights):
            hit = detect(self, index, pose, points, weights)
            return (np.asarray(pose, float), 0.01 * np.eye(6), 1.0) if index == 5 else hit
        return f

    monkeypatch.setattr(ploop.LoopDetector, "detect", firing(ploop.LoopDetector.detect))
    monkeypatch.setattr(rloop.LoopDetector, "detect", firing(rloop.LoopDetector.detect))
    seen, compare = [], check.compare
    monkeypatch.setattr(check, "compare", lambda rec, *a, **k: seen.append(list(rec.segments)) or compare(rec, *a, **k))
    res = run_tiny("flagship-live10hz", seconds=1.5)
    assert (5, 3) in seen[0] and res["correct"] is True
    assert all(v["value"] == 0.0 for v in res["compared"].values())
