"""Open loop: a robot's scans released at the sensor's rate into
runner.run_stream with a loop detector and the status stream (what
`eval.run --loop` runs), one call over the whole window.

Traffic parameters:
  rate_hz       the sensor's scan rate; scan i is due at t0 + i / rate_hz;
  warm_scans    scans of the warm-up run_stream call (set-up: the graph's
                capture, the keyframe path, the detector);
  status_every  the status stream's period in scans (written under TMPDIR);
  late_after_s  a scan whose pose comes later than this after it was due
                counts as failed (one scan period: the system fell behind);
  check_scans   L, the length of a compared segment;
  check_segments  how many segments [k, k + L) the seed draws, k a
                multiple of L (a keyframe boundary);
  traced_scans  the window's last scans that a traced run profiles;
  synthetic     the trajectory: the scans are made from the seed by the
                frozen generator, on the host, as a robot's driver hands
                them over.

The pacing object is list-like: run_stream reads scan i through
__getitem__(i), which blocks until scan i is due. Scan i's latency runs
from when it was due to when the runner asks for scan i + 1 (its pose has
been read back by then), the last scan's to run_stream's return;
live_p95_ms is the 95th percentile over every scan of the window. The
compared segments are scan 0 from init_state, `check_segments` segments
[k, k + L) drawn from the seed, and [j, j + L) from the first scan j to
which the detector gave a loop factor, each from the state the runner held
before its first scan (taken in the detector's hooks)."""

from __future__ import annotations

import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np

from benchmark.drivers.common import HostSnapshot, Program, Spans, TimedDetector, seeded
from benchmark.gen import scans as gen
from benchmark.reference import check


class Paced:
    """The scans as run_stream reads them: item i blocks until it is due."""

    def __init__(self, batches: list, rate_hz: float, on_request=None):
        self.batches = batches
        self.period = 1.0 / rate_hz
        self.t0 = None
        self.requested = [None] * len(batches)
        self.on_request = on_request

    def due(self, i: int) -> float:
        return self.t0 + i * self.period

    def __len__(self) -> int:
        return len(self.batches)

    def __getitem__(self, i: int):
        from torch.profiler import record_function

        self.requested[i] = time.perf_counter()
        if self.on_request is not None:
            self.on_request(i)
        with record_function("bench.sensor_wait"):
            while True:
                wait = self.due(i) - time.perf_counter()
                if wait <= 0:
                    return self.batches[i]
                time.sleep(wait)

    def latencies(self, t_end: float) -> list:
        """Seconds from each scan's due time to its pose on the host."""
        ends = self.requested[1:] + [t_end]
        return [e - self.due(i) for i, e in enumerate(ends)]


def p95(values: list) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def drive(run) -> None:
    cfg, tr = run.cell.config, run.cell.traffic
    L, warm = tr["check_scans"], tr["warm_scans"]
    n = math.ceil(tr["rate_hz"] * run.seconds)
    starts = np.arange(L, n - L + 1, L)
    drawn = sorted(int(k) for k in seeded(run.seed, 2).choice(starts, min(tr["check_segments"], len(starts)),
                                                              replace=False))
    prog = Program(cfg, run.device)
    run.program = prog
    ref_batches = gen.synthetic_scans(cfg, tr, run.seed, max(n, warm))
    batches = prog.batches(ref_batches)
    run.program_init = check.state_tree(prog.init_state(prog.cfg, device=run.device))
    like = prog.init_state(prog.cfg, device=run.device)
    snaps = {i: HostSnapshot(like) for k in drawn for i in (k, k + L)}
    spare = [HostSnapshot(like), HostSnapshot(like)]  # the loop segment's start and end
    looped = []
    tmp = tempfile.TemporaryDirectory()
    status = os.path.join(tmp.name, "status.jsonl")

    def on_store(i):
        if i + 1 in snaps:
            snaps[i + 1].take(prog.live_state())

    def on_hit(i):  # before scan i's step: the runner holds the state before scan i
        if not looped and i + L <= n:
            looped.append(i)
            if i not in snaps:  # else taken already, as another segment's start or end
                snaps[i] = spare[0]
                snaps[i].take(prog.live_state())
            snaps.setdefault(i + L, spare[1])

    prog.runner.run_stream(batches[:warm], prog.cfg, loop_detector=prog.detector(), status_path=status,
                           status_every=tr["status_every"], device=run.device)  # warm-up
    det = TimedDetector(prog.detector(), run.spans, True, on_store, on_hit)
    traced = tr["traced_scans"] if run.trace else 0
    held = {}

    def on_request(i):  # the window's last `traced` scans run under the profiler, with their own spans
        if traced and i == n - traced:
            held["spans"], run.spans = run.spans, Spans()
            det.spans = run.spans
            run.trace_begin()

    paced = Paced(batches[:n], tr["rate_hz"], on_request)
    run.begin_window()
    det.spans = run.spans
    paced.t0 = time.perf_counter()
    try:
        _, out = prog.runner.run_stream(paced, prog.cfg, loop_detector=det, status_path=status,
                                        status_every=tr["status_every"], device=run.device)
    finally:
        t_end = time.perf_counter()
        tmp.cleanup()
    run.end_window()
    if traced:  # stopped once the window has closed: reading the trace holds up no scan
        run.trace_end(traced)
        run.spans = held["spans"]
    lat = paced.latencies(t_end)
    poses = out.pose.cpu().numpy()
    run.attempted = n
    run.nonfinite = int((~np.isfinite(poses).all(axis=1)).sum())
    run.late = sum(1 for x in lat if x > tr["late_after_s"])
    run.e2e["live_p95_ms"] = 1e3 * p95(lat)
    slow = sorted(range(n), key=lambda i: -lat[i])[:5]
    print("benchmark: slowest scans: " + ", ".join(f"{i} {1e3 * lat[i]:.1f} ms" for i in slow), file=sys.stderr)
    hits = [c[1] for c in det.calls if c[0] == "detect" and c[3] is not None]
    print(f"benchmark: loop factors at scans {hits}", file=sys.stderr)
    run.span_scans = n - traced
    states = {i: s.tree() for i, s in snaps.items() if s.taken}
    tapes = {f: getattr(out.tape, f).cpu().numpy() for f in out.tape._fields}
    run.record = check.PassRecord(ref_batches=ref_batches, poses=poses, tapes=tapes, states=states,
                                  segments=[(0, 1)] + [(k, L) for k in sorted(set(drawn) | set(looped))],
                                  loop=check.LoopCalls(det.calls, inject_positive_only=False))
