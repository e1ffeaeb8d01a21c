"""Helpers of the benchmark's tests: cells cut to a size the CPU runs in
seconds, and the program's runner on the CPU (eager), with the state
after its last step where the card's runner keeps the compiled step's."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)

# Cells that BENCHMARK.json holds no longer: their configuration, traffic
# mixes, drivers and readers stay, so a later change adds each back with its
# entries and a limits file alone. The tests add the entries as that change
# would, and judge the kept cells by these limits (on the CPU every compared
# number reads 0).
LIVE, BAG = "flagship-live10hz", "kimera-bag"
KEPT_CONFIGS = [
    {"name": "kimera_jackal", "source": "Kimera-Multi data (MIT-SPARK), 10_14 campus, acl_jackal-005; GC-SLAM "
     "config/gc_unified.yaml run settings + time_alignment/kimera_10_14_acl_jackal_005.yaml; VLP-16 10 Hz, RGB-D "
     "640x480", "file": "benchmark/configs/kimera_jackal.json", "reduced": ["n_scans"],
     "why": "the Kimera acl_jackal deployment: camera on (512 RGB-D features), atlas 64 x 1024, 512 surfels"},
]
KEPT_WORKLOADS = [
    {"name": BAG, "config": "kimera_jackal", "traffic": "bag_file", "chips": 1,
     "why": "eval.run --bag --loop --chunk 10 on a 50-scan camera-on bag file, closed loop"},
    {"name": LIVE, "config": "flagship", "traffic": "live_10hz", "chips": 1,
     "why": "a robot live: scans at 10 Hz on a 1.5 m circuit into run_stream with loop detection, open loop"},
    {"name": "kimera-replay", "config": "kimera_jackal", "traffic": "bag_replay", "chips": 1,
     "why": "the Kimera bag decoded once in set-up, replayed back to back through run_chunked"},
]
KEPT_END_TO_END = [
    {"name": "bag_ms_per_scan", "unit": "ms/scan", "better": "lower", "bound": 0.25, "source": "host_clock",
     "workloads": [BAG]},
    {"name": "live_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
     "workloads": [LIVE]},
]
KEPT_PER_LAYER = [
    {"name": "decode_ms_per_scan.bag", "unit": "ms/scan", "better": "lower", "source": "host_clock",
     "layer": "bag frontend", "moves": "bag_ms_per_scan", "workloads": [BAG]},
    {"name": "device_idle_share.bag", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
     "moves": "bag_ms_per_scan", "workloads": [BAG]},
    {"name": "loop_ms_per_scan.live", "unit": "ms/scan", "better": "lower", "source": "host_clock",
     "layer": "loop closure", "moves": "live_p95_ms", "workloads": [LIVE]},
    {"name": "device_idle_share.live", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
     "moves": "live_p95_ms", "workloads": [LIVE]},
]
_GAPS = {"init_mismatch": 0, "pose_gap_m": 1e-4, "rot_gap_rad": 1e-4, "tape_gap_median": 1e-3,
         "state_gap_median": 1e-6, "loop_mismatch": 0}
KEPT_LIMITS = {
    LIVE: _GAPS,
    BAG: dict(_GAPS, resume_mismatch=0, decode_gap=1e-4),
    "kimera-replay": dict(_GAPS, resume_mismatch=0, decode_gap=1e-4),
}


def with_kept(bench: dict) -> dict:
    """BENCHMARK.json with the kept cells' entries added, as a change that
    brings them back would add them."""
    bench = copy.deepcopy(bench)
    bench["configs"] += copy.deepcopy(KEPT_CONFIGS)
    bench["workloads"] += copy.deepcopy(KEPT_WORKLOADS)
    bench["end_to_end"] += copy.deepcopy(KEPT_END_TO_END)
    bench["per_layer"] += copy.deepcopy(KEPT_PER_LAYER)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship-replay" in m.get("workloads", []):
            m["workloads"].append("kimera-replay")
    return bench


def tiny_cell(name: str):
    """The cell `name` of BENCHMARK.json (or a kept one) at a size the CPU
    runs in seconds: SMALL budgets, 12-scan bags of few points, 3-scan
    segments and chunks, 160 x 120 camera frames."""
    from benchmark import spec

    c = copy.deepcopy(spec.load_cell(name, spec=with_kept(spec.load_spec())))
    cfg, tr = c.config, c.traffic
    cfg["pipeline"].update(SMALL)
    cfg["n_scans"] = 12
    tr["check_scans"] = min(tr["check_scans"], 3)
    if "frontend" in cfg:
        cfg["synthetic"]["n_points"] = 2048
        cfg["frontend"]["n_points"] = 512
        cfg["bag"]["cam_size"] = [160, 120]
        cfg["frontend"]["camera_intrinsics"] = [x / 4 for x in cfg["frontend"]["camera_intrinsics"]]
    else:
        cfg["synthetic"]["n_points"] = 512
    if "chunk" in tr:
        tr["chunk"] = 3
        cfg["loop"]["keyframe_every"] = 3
    if "bags" in tr:
        tr["bags"] = 2
    if "warm_scans" in tr:
        tr["warm_scans"] = 3
        tr["traced_scans"] = 3
        tr["late_after_s"] = 1e9
    return c


@pytest.fixture
def cpu_runner(monkeypatch):
    """The program's StepLoop on the CPU, remembering the state after each
    step as Program.live_state."""
    import torch

    from benchmark.drivers import common
    from gcslam_torch.models import runner

    torch.set_num_threads(2)
    last = {}
    step = runner.StepLoop.step

    def remembering(self, batch):
        out = step(self, batch)
        last["state"] = out[0]
        return out

    monkeypatch.setattr(runner.StepLoop, "step", remembering)
    monkeypatch.setattr(common.Program, "live_state", lambda self: last["state"])
    return last


def run_tiny(name: str, seconds: float = 1.0, seed: int = 2**31 + 7, cell=None, trace: bool = False):
    """One run of the tiny cell on the CPU through the harness (its look for
    a card skipped); returns the result dict."""
    import importlib
    import time

    import torch

    from benchmark import harness

    cell = tiny_cell(name) if cell is None else cell
    run = harness.Run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
    kept = KEPT_LIMITS.get(cell.name)
    load = harness.load_limits
    if kept is not None:  # a kept cell has no limits file: a later change adds it
        harness.load_limits = lambda name: dict(kept)
    try:
        return harness.execute(run, importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}"))
    finally:
        harness.load_limits = load


def cpu_patches() -> None:
    """cpu_runner's patches for a process of its own (no fixture)."""
    from benchmark.drivers import common
    from gcslam_torch.models import runner

    last = {}
    step = runner.StepLoop.step

    def remembering(self, batch):
        out = step(self, batch)
        last["state"] = out[0]
        return out

    runner.StepLoop.step = remembering
    common.Program.live_state = lambda self: last["state"]
