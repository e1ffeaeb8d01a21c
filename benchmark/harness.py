"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result's last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic mix names its driver (drivers/<driver>.py), which makes
the inputs from the seed, warms up the program on them, runs the window and
keeps what the comparison needs of one pass drawn from the seed. The peak
of device memory is read as the window closes; setup_s is the time from the
process's start to the window's, less what a driver keeps apart (a seed's
first writing of its bag file). The harness then frees the program's state,
runs the reference, checks that no JAX module was loaded, and prints the
compared numbers beside their limits on standard error and one JSON line on
standard output. With --trace 1 one stretch early in the window runs under
torch.profiler and the line carries the cell's per-layer metrics;
otherwise its end-to-end metrics."""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import pkgutil
import subprocess
import sys
import time
from typing import Dict, Optional

from benchmark import guard, spec
from benchmark.drivers.common import Spans
from benchmark.trace import Stretch, Tracer

LIMITS_DIR = os.path.join(spec.BENCH_DIR, "limits")


class Run:
    """What a driver reads and fills in one run."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device = device
        self.t_start = t_start
        self.spans = Spans()
        self.tracer = Tracer() if trace else None
        self.stretch: Optional[Stretch] = None
        self.counters_traced: Dict[str, tuple] = {}
        self.window_start = None
        self.window_s = None
        self.attempted = 0  # scans in the window
        self.nonfinite = 0  # scans whose pose is not finite
        self.raised = 0  # passes that raised
        self.late = 0  # scans that missed the traffic's latency limit
        self.e2e: Dict[str, float] = {}
        self.record = None  # reference.check.PassRecord of the compared pass
        self.program = None
        self.program_init = None  # state_tree of the program's init_state
        self.capture_s = None
        self.setup_apart_s = 0.0  # set-up kept out of setup_s: a seed's first run writing its input file
        self.pass_s = []  # seconds of each pass of the window
        self.card_after = ""  # the card's clocks and state as the window closed
        self.peak_bytes = None  # the peak of device memory as the window closed

    def begin_window(self) -> None:
        self.spans = Spans()
        self.window_start = time.perf_counter()

    def end_window(self) -> None:
        self.window_s = time.perf_counter() - self.window_start
        if self.device.type == "cuda":
            import torch

            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            self.card_after = card_state()

    def elapsed(self) -> float:
        return time.perf_counter() - self.window_start

    def trace_begin(self) -> None:
        self._counters0 = {k: c.snapshot() for k, c in _roofline_counters().items()}
        self.tracer.start()

    def trace_end(self, n_scans: int) -> None:
        self.stretch = self.tracer.stop(n_scans)
        for k, c in _roofline_counters().items():
            n0, by0 = self._counters0[k]
            n1, by1 = c.snapshot()
            self.counters_traced[k] = (n1 - n0, by1 - by0)


def _roofline_modules():
    from benchmark import roofline

    return {m.name: importlib.import_module(f"benchmark.roofline.{m.name}")
            for m in pkgutil.iter_modules(roofline.__path__)}


def _roofline_counters() -> dict:
    """The program's launch counter of each kernel that roofline/ models."""
    out = {}
    for name, mod in _roofline_modules().items():
        module, attr = mod.COUNTER
        out[name] = getattr(importlib.import_module(module), attr)
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def load_limits(cell: str) -> Dict[str, float]:
    with open(os.path.join(LIMITS_DIR, cell + ".json")) as f:
        return json.load(f)["limits"]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number finite and at or under its limit, and every
    limit's number present."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def card_state() -> str:
    """The card's SM clock, temperature, power draw and active clock-event
    reasons (nvidia-smi), to tell a slow run's cause."""
    fields = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw,clocks_event_reasons.active"
    for q in (fields, fields.rsplit(",", 1)[0]):
        try:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.SubprocessError) as e:
            return f"nvidia-smi: {e}"
        if out.returncode == 0:
            return f"{q}: {out.stdout.strip()}"
    return "nvidia-smi: " + out.stdout.strip()


def per_layer(run: Run) -> Dict[str, dict]:
    ctx = {"run": run, "stretch": run.stretch, "spans": run.spans, "counters": run.counters_traced,
           "rooflines": _roofline_modules()}
    out = {}
    for m in run.cell.per_layer:
        v = spec.metric_reader(m["name"])(ctx, m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def setup_s(run: Run) -> float:
    return run.window_start - run.t_start - run.setup_apart_s


def end_to_end(run: Run, peak_bytes: int) -> Dict[str, dict]:
    values = dict(run.e2e, setup_s=setup_s(run), peak_device_mib=peak_bytes / 2**20)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in run.cell.end_to_end}


def release_program(run: Run) -> None:
    """Free the program's graphs and state before the reference runs."""
    import gc

    import torch

    if run.program is not None:
        run.program.runner.release_graphs()
    run.program = None
    gc.collect()
    torch.cuda.empty_cache()


def execute(run: Run, driver) -> dict:
    """Drive the cell, compare, and return the result (without printing)."""
    import torch

    from benchmark.reference import check

    driver.drive(run)
    if run.program is not None:
        steps = run.program.runner.compiled_steps()
        caps = [s.capture_s for s in steps if s.capture_s is not None]
        run.capture_s = sum(caps) if caps else None
    # read as the window closed: what a driver runs after it for the comparison does not count
    peak = run.peak_bytes if run.peak_bytes is not None else 0
    metrics = per_layer(run) if run.trace else end_to_end(run, peak)
    release_program(run)
    t0 = time.perf_counter()
    detail = {}
    numbers = check.compare(run.record, run.cell.config, run.program_init, run.device, detail)
    for k, v in detail.items():
        if v:
            print(f"benchmark: worst in {k}: {v}", file=sys.stderr)
    print(f"benchmark: {run.cell.name} seed {run.seed}: set-up {setup_s(run):.3f} s (and {run.setup_apart_s:.3f} s "
          f"kept apart), window {run.window_s:.3f} s, {run.attempted} scans, "
          f"reference {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    if run.pass_s:
        q = sorted(run.pass_s)
        print(f"benchmark: {len(q)} passes of {q[0]:.4f} / {q[len(q) // 2]:.4f} / {q[-1]:.4f} s (least, median, "
              "most)", file=sys.stderr)
    if run.card_after:
        print(f"benchmark: the card as the window closed: {run.card_after}", file=sys.stderr)
    limits = load_limits(run.cell.name)
    correct = judge(numbers, limits) and run.raised == 0 and run.nonfinite == 0
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.nonfinite + run.raised + run.late,
              "metrics": metrics, "device": device}
    if run.trace and run.stretch is not None:
        device.update(busy_s=run.stretch.busy_s, window_s=run.stretch.window_s)
        result["breakdown"] = run.stretch.breakdown()
    # a number that is not finite (or missing) is written as null: the run is not correct
    result["compared"] = {k: {"value": numbers[k] if math.isfinite(numbers.get(k, math.nan)) else None, "limit": v}
                          for k, v in limits.items()}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = _parser().parse_args(argv)
    bad = guard.source_violations()
    if bad:
        print("benchmark: forbidden imports in the benchmark's sources: " + "; ".join(bad), file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    chips = {w["name"]: w["chips"] for w in spec.load_spec()["workloads"]}[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    result = execute(run, driver)
    loaded = guard.forbidden_loaded(sys.modules)
    if loaded:
        print("benchmark: forbidden modules loaded in this process: " + ", ".join(loaded), file=sys.stderr)
        return 3
    if run.trace:
        print(f"card and power limit: {power_limit()}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
