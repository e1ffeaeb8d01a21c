"""What the drivers share: the program under test, the harness's own spans
around the calls it makes, and the timing wrapper of the loop detector."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np


class Spans:
    """Host-clock seconds of the harness's spans, by name; each span is also
    a torch.profiler range `bench.<name>` (the traced run's idle gaps are
    labelled by them)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function("bench." + name):
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


class Program:
    """The system under test (gcslam_torch): its entry points, imported when
    the harness has set the run's environment."""

    def __init__(self, config: dict, device):
        import torch

        from gcslam_torch.frontend import loop, rosbag
        from gcslam_torch.models import runner
        from gcslam_torch.models.config import PipelineConfig
        from gcslam_torch.models.scan_io import batch_from_numpy
        from gcslam_torch.models.scan_step import init_state

        self.torch = torch
        self.runner, self.rosbag, self.loop = runner, rosbag, loop
        self.batch_from_numpy = batch_from_numpy
        self.init_state = init_state
        self.device = device
        self.cfg = PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config["pipeline"].items()})
        self.loop_cfg = loop.LoopConfig(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in config["loop"].items()})

    def batches(self, ref_batches: list) -> list:
        """The benchmark's scans as the program's ScanBatch, through the
        program's batch_from_numpy (the same tensors where the dtypes agree)."""
        return [self.batch_from_numpy(b._asdict(), device=b.points.device) for b in ref_batches]

    def detector(self):
        return self.loop.LoopDetector(self.loop_cfg)

    def live_state(self):
        """The state the runner holds after its last step (the compiled
        step's buffers)."""
        return self.runner.compiled_steps()[-1].state


class TimedDetector:
    """The program's LoopDetector as the runner sees it, with the time of
    every detect and store call in the span `loop`, and, when `record`, the
    calls with their results (for the comparison). `on_store(index)` runs
    after each store call, `on_hit(index)` after each detect call that
    found a factor (before the scan's step)."""

    def __init__(self, det, spans: Spans, record: bool, on_store=None, on_hit=None):
        self.det = det
        self.cfg = det.cfg
        self.spans = spans
        self.calls: List[tuple] = [] if record else None
        self.on_store = on_store
        self.on_hit = on_hit

    def detect(self, index, pose_guess, points, weights):
        with self.spans.span("loop"):
            hit = self.det.detect(index, pose_guess, points, weights)
        if self.calls is not None:
            self.calls.append(("detect", index, np.array(pose_guess), hit))
        if hit is not None and self.on_hit is not None:
            self.on_hit(index)
        return hit

    def store(self, index, pose_est, points, weights, pose_cov=None):
        with self.spans.span("loop"):
            self.det.store(index, pose_est, points, weights, pose_cov)
        if self.calls is not None:
            self.calls.append(("store", index, np.array(pose_est), None if pose_cov is None else np.array(pose_cov)))
        if self.on_store is not None:
            self.on_store(index)


def segments(n: int, L: int) -> list:
    """The compared segments (first scan, scans) of an n-scan pass: scan 0
    from init_state, scans 1 to L - 1 one each, then [k, k + L) for every
    k = L, 2L, ... < n, each from the program's state before its first
    scan (L = 1: every scan from the state before it)."""
    return [(0, 1)] + [(i, 1) for i in range(1, min(L, n))] + [(k, min(L, n - k)) for k in range(L, n, L)]


def with_factor(batch, hit):
    """The program's scan batch with its loop channel set to a detector's
    factor (loop_pose, loop_cov, weight), as the runner merges it."""
    import torch

    def like(x, v):
        return torch.as_tensor(np.asarray(v), dtype=x.dtype, device=x.device)

    return batch._replace(loop_pose=like(batch.loop_pose, hit[0]), loop_cov=like(batch.loop_cov, hit[1]),
                          loop_weight=like(batch.loop_weight, hit[2]))


def chunked_factors(calls: list, n: int, chunk: int) -> dict:
    """scan -> the factor run_chunked(chunk) merged into it: a detect result
    of weight > 0 for the first scan of a full window."""
    n_full = n // chunk * chunk
    return {c[1]: c[3] for c in calls if c[0] == "detect" and c[3] is not None and c[3][2] > 0 and c[1] < n_full}


def resumed(prog, batches: list, cuts: list, device, poses, tapes, states: dict, factors=None) -> int:
    """The compared pass again, once the window has closed: run_bag over the
    pieces of `batches` (with `factors` merged, scan -> factor) that end at
    each of `cuts` (the last is the pass's end), each from the state the
    last returned; `states` gets the state at each cut but the last, where
    it holds the timed pass's. Returns the elements of the pieces' poses,
    tapes and final state that differ from the timed pass's: 0 shows that
    the states are those the timed pass held (run_bag resumes from a given
    state; run_chunked steps the same captured step on the same scans)."""
    from benchmark.reference.check import mismatches, state_tree

    factors = factors or {}
    batches = [with_factor(b, factors[i]) if i in factors else b for i, b in enumerate(batches)]
    s, start, ps, ts = None, 0, [], []
    for cut in cuts:
        s, o = prog.runner.run_bag(batches[start:cut], prog.cfg, state=s, device=device)
        if cut < cuts[-1]:
            states[cut] = state_tree(s)
        ps.append(o.pose.cpu().numpy())
        ts.append(tapes_of(o))
        start = cut
    mine = {"pose": np.concatenate(ps), "final": state_tree(s),
            **{f: np.concatenate([t[f] for t in ts]) for f in tapes}}
    return mismatches(mine, {"pose": poses, "final": states[cuts[-1]], **tapes})


def tapes_of(out) -> Dict[str, np.ndarray]:
    return {f: getattr(out.tape, f).cpu().numpy() for f in out.tape._fields}


def seeded(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


class HostSnapshot:
    """Preallocated host buffers (pinned on a CUDA device) shaped like a
    state tree; take(state) copies the state into them without waiting for
    the device, tree() waits and returns the copy as numpy arrays."""

    def __init__(self, like):
        import torch

        def alloc(x):
            if x is None:
                return None
            if hasattr(x, "_fields"):
                return type(x)(*[alloc(getattr(x, f)) for f in x._fields])
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)

        self.buf = alloc(like)
        self.taken = False

    def take(self, state) -> None:
        def cp(dst, src):
            if dst is None:
                return
            if hasattr(dst, "_fields"):
                for f in dst._fields:
                    cp(getattr(dst, f), getattr(src, f))
            else:
                dst.copy_(src, non_blocking=True)

        cp(self.buf, state)
        self.taken = True

    def tree(self):
        import torch

        from benchmark.reference.check import state_tree

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return state_tree(self.buf)


def window_of_passes(run, one_pass, sampled: int):
    """Closed-loop passes back to back until the window's `seconds` have
    passed (the pass that crosses them counts whole), the second one traced
    with spans of its own in a traced run; each pass's seconds go to
    run.pass_s. one_pass(record) returns (scans,
    poses (n, 6) on the host, what the comparison keeps when `record`); pass
    `sampled` records. A pass that raises is counted and the window goes
    on. Returns the sampled pass's record, or None when it raised."""
    import sys

    run.begin_window()
    span_scans = 0
    j = 0
    kept = None
    while True:
        traced = run.trace and j == 1
        if traced:
            window_spans, run.spans = run.spans, Spans()
            run.trace_begin()
        n = 0
        t0 = time.perf_counter()
        try:
            n, poses, rec = one_pass(j == sampled)
            run.nonfinite += int((~np.isfinite(poses).all(axis=1)).sum())
            if j == sampled:
                kept = rec
        except Exception as e:  # counted in `failed`; the window goes on
            print(f"benchmark: pass {j} raised {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            run.raised += 1
        run.attempted += n
        run.pass_s.append(time.perf_counter() - t0)
        if traced:
            run.trace_end(n)
            run.spans = window_spans
        else:
            span_scans += n
        j += 1
        if run.elapsed() >= run.seconds and j > max(sampled, 1 if run.trace else 0):
            break
    run.end_window()
    run.span_scans = span_scans
    return kept
