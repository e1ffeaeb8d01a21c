"""Run loops (counterpart of the JAX package's models/runner.py): host
loops over scan_step on one device, each returning the final state and the
per-scan outputs stacked along a leading time axis.

  - run_bag(): replay a list of scans;
  - run_scan(): replay a ScanBatch stacked along a leading time axis;
  - run_stream(): the online loop — loop-closure detection between steps,
    the incremental map stream and the periodic status stream;
  - run_chunked(): windows of `chunk` scans with loop-closure detection at
    the window boundaries (the JAX package's one-program-per-chunk live
    mode; here a window is `chunk` replays of the compiled step, so its
    poses equal run_bag's bit for bit when no loop fires).

All of them run the same scan_step call sequence; they differ only in what
the host does between steps. On the CPU each step is the eager scan_step.
On CUDA each step is a replay of CompiledStep, scan_step captured as one
CUDA graph per (config, device, belief dtype, state and batch shapes):
the counterpart of the JAX runner's _step_jit / _chunk_jit (one compiled
program, the state donated) and make_device_stager (the scans staged on
the device). The host's work per scan is a device-to-device copy of the
scan into the graph's static batch, one graph launch and a copy of the
step's outputs into the run's stacked outputs; the first scan of a config
runs eagerly on a side stream (it loads the libraries and makes the
library handles and constant caches the capture needs) before the capture.
A capture that fails raises: there is no eager retry on CUDA.

Every copy the runners make to the device and every value they read back
goes through the transfer ledger (utils/profiling.COUNTERS), as the JAX
package's runners do: run_bag and run_scan commit the whole bag in one
call and read nothing back; run_stream commits scan by scan, run_chunked
all full windows at once and the remainder scan by scan.

What the host does is timed in spans (utils/profiling.span): run_bag and
run_scan's staging of the bag (run_bag.start, run_bag.stack,
run_bag.to_device), run_chunked's (run_chunked.start, .stack,
.to_device) and its work at the window boundaries (run_chunked.poses,
run_chunked.loop), and each scan's staging and replay (step.launch) and
output copies (step.outputs). On the device, each CompiledStep's stage
clock times the step's stages at every replay (stage_reading()).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from gcslam_torch import constants as C
from gcslam_torch.models.belief import Belief
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import ScanBatch, stack_scan_batches
from gcslam_torch.models.scan_step import ScanTape, StepOutput, StepState, init_state, scan_step, state_to
from gcslam_torch.ops import linalg
from gcslam_torch.ops.certs import TRIGGERS
from gcslam_torch.ops.cuda_build import LaunchCounter
from gcslam_torch.utils.device import resolve_device
from gcslam_torch.utils.dtypes import BELIEF_DTYPE
from gcslam_torch.utils.profiling import COUNTERS, StageClock, StageReading, span, stages
from gcslam_torch.utils.tree import tree_leaves, tree_rebuild

MAX_GRAPHS = 2  # compiled steps kept; the least recently used one is freed first
_GRAPHS: "collections.OrderedDict[tuple, CompiledStep]" = collections.OrderedDict()


def stack_outputs(outs: List[StepOutput]) -> StepOutput:
    return StepOutput(
        pose=torch.stack([o.pose for o in outs]),
        stamp=torch.stack([o.stamp for o in outs]),
        tape=ScanTape(*[torch.stack([getattr(o.tape, f) for o in outs]) for f in ScanTape._fields]),
    )


def _copy_into(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """dst <- src for every pair (one foreach call, a few launches)."""
    if dsts:
        torch._foreach_copy_(dsts, srcs)


def _write_state(dst: StepState, new: StepState) -> None:
    """The state buffers `dst` <- the step's new state. A new leaf that is
    the buffer itself is skipped; one that shares memory with some buffer
    is copied out first, so that no buffer is written before it is read."""
    dsts, srcs = tree_leaves(dst), tree_leaves(new)
    bases = {d.untyped_storage().data_ptr() for d in dsts}
    pairs = []
    for d, x in zip(dsts, srcs):
        if x.shape != d.shape or x.dtype != d.dtype:
            raise RuntimeError(f"scan_step changed a state leaf from {tuple(d.shape)} {d.dtype} to "
                               f"{tuple(x.shape)} {x.dtype}")
        if x.data_ptr() == d.data_ptr() and x.stride() == d.stride():
            continue
        pairs.append((d, x.clone() if x.untyped_storage().data_ptr() in bases else x))
    _copy_into([d for d, _ in pairs], [x for _, x in pairs])


class CompiledStep:
    """scan_step with static buffers, replayed as one captured CUDA graph.

    `state` and `batch` hold the graph's static state and scan buffers.
    The captured body is scan_step(state, batch) followed by the copy of
    the new state into the state buffers (the JAX runner's donated
    state), so replays chain; `out` holds the body's StepOutput, which the
    next step overwrites. step(batch) stages the scan into the batch
    buffers (device-to-device) and replays. Its first call runs the scan
    eagerly on a side stream, which loads the libraries, builds the
    kernels and makes the library handles and the step's constant caches,
    then captures; its result is that scan's. A kernel wrapper's launch
    counter (ops/cuda_build.LaunchCounter) moves at capture, where nothing
    runs: the capture's counts are taken back out and added at every
    replay. capture=False runs the same body without a graph (the CPU
    test of the compiled path).

    `stage_clock` (a utils/profiling.StageClock, made when the argument is
    true) times the body's stages at every step: its stamps are captured
    into the graph, and its totals stay on the device until
    stage_clock.read(). stage_clock=False captures the body without the
    stamps (its stage ranges stay), to price the clock."""

    def __init__(self, config: PipelineConfig, state: StepState, batch: ScanBatch, capture: bool = True,
                 stage_clock: bool = True):
        self.config = config
        self.capture = capture
        self.stage_clock = StageClock(state.hyp_weights.device) if stage_clock else None
        self.state = tree_rebuild(state, [x.clone() for x in tree_leaves(state)])
        self.batch = tree_rebuild(batch, [x.clone() for x in tree_leaves(batch)])
        self.graph = None
        self.out = None
        self.counts = []  # per LaunchCounter.instances: the snapshot of one replay's launches
        self.capture_s = None  # host seconds of the capture, instantiation included
        self.replays = 0

    def load_state(self, state: StepState) -> None:
        _copy_into(tree_leaves(self.state), tree_leaves(state))

    def _body(self) -> StepOutput:
        clock = self.stage_clock
        new_state, out = scan_step(self.state, self.batch, self.config, clock=clock)
        with stages(clock) as mark:
            mark("write_state")
            bases = {x.untyped_storage().data_ptr() for x in tree_leaves(self.state)}
            out = tree_rebuild(out, [x.clone() if x.untyped_storage().data_ptr() in bases else x
                                     for x in tree_leaves(out)])
            _write_state(self.state, new_state)
            if clock is not None:
                clock.end_step()
        return out

    def step(self, batch: ScanBatch) -> StepOutput:
        """One scan from the state buffers into them; the output's tensors
        are overwritten by the next step. After the first, each step is the
        host span step.launch."""
        if self.capture and self.graph is None:
            return self._first_step(batch)
        with span("step.launch"):
            _copy_into(tree_leaves(self.batch), tree_leaves(batch))
            if not self.capture:
                return self._body()
            self.graph.replay()
            for c, snap in zip(LaunchCounter.instances, self.counts):
                c.add(snap)
            self.replays += 1
        return self.out

    def _first_step(self, batch: ScanBatch) -> StepOutput:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            new_state, out = scan_step(self.state, batch, self.config)
            _write_state(self.state, new_state)
        main.wait_stream(side)
        counters = LaunchCounter.instances
        saved = [c.snapshot() for c in counters]
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.out = self._body()
        finally:
            self.counts = [c.snapshot() for c in counters]
            for c, snap in zip(counters, saved):
                c.restore(snap)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        return out


def _signature(tree) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in tree_leaves(tree))


def compiled_step(config: PipelineConfig, state: StepState, batch: ScanBatch) -> CompiledStep:
    """The cached CompiledStep of this (config, device, belief dtype, state
    and batch shapes), its state buffers loaded with `state`. At most
    MAX_GRAPHS are kept: the least recently used is freed, graph, memory
    pool and buffers, when another is made."""
    key = (config, state.hyp_weights.device, BELIEF_DTYPE, _signature(state), _signature(batch))
    step = _GRAPHS.pop(key, None)
    if step is None:
        while len(_GRAPHS) >= MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        step = CompiledStep(config, state, batch)
    else:
        step.load_state(state)
    _GRAPHS[key] = step
    return step


def release_graphs() -> None:
    """Free every cached CompiledStep."""
    _GRAPHS.clear()


def compiled_steps() -> List[CompiledStep]:
    """The cached CompiledSteps, least recently used first."""
    return list(_GRAPHS.values())


def stage_reading() -> Optional[StageReading]:
    """The stage clocks of the cached CompiledSteps, summed (a copy and a
    sync each); None where no step has ended on one."""
    readings = [s.stage_clock.read() for s in _GRAPHS.values() if s.stage_clock is not None]
    total = sum(readings[1:], readings[0]) if readings else None
    return total if total is not None and total.scans else None


class StepLoop:
    """scan_step over the n scans of one runner call, picked by the state's
    device: the eager step on the CPU, replays of the cached CompiledStep
    on CUDA. step(batch) returns the state after the scan (with the
    compiled step the live state buffers, valid until the next step) and
    the scan's output (with the compiled step a view of the run's stacked
    outputs)."""

    def __init__(self, config: PipelineConfig, state: StepState, n: int):
        self.config = config
        self.state = state
        self.n = n
        self.use_compiled = state.hyp_weights.is_cuda
        self.compiled = None
        self.outs = []
        self.stacked = None

    def step(self, batch: ScanBatch) -> Tuple[StepState, StepOutput]:
        if not self.use_compiled:
            self.state, out = scan_step(self.state, batch, self.config)
            self.outs.append(out)
            return self.state, out
        if self.compiled is None:
            self.compiled = compiled_step(self.config, self.state, batch)
            if self.compiled.stage_clock is not None:
                self.compiled.stage_clock.begin_call()
        out = self.compiled.step(batch)
        with span("step.outputs"):
            leaves = tree_leaves(out)
            if self.stacked is None:
                self.stacked = [x.new_empty((self.n,) + x.shape) for x in leaves]
            rows = [x[len(self.outs)] for x in self.stacked]
            _copy_into(rows, leaves)
            self.outs.append(tree_rebuild(out, rows))
        return self.compiled.state, self.outs[-1]

    def result(self) -> Tuple[StepState, StepOutput]:
        """The final state (with the compiled step a copy of the buffers) and
        the stacked outputs."""
        if not self.use_compiled:
            return self.state, stack_outputs(self.outs)
        if self.compiled.stage_clock is not None:
            self.compiled.stage_clock.end_call()
        state = self.compiled.state
        return (tree_rebuild(state, [x.clone() for x in tree_leaves(state)]),
                tree_rebuild(self.outs[0], self.stacked))


def eager_steps(state: StepState, batches: List[ScanBatch], config: PipelineConfig) -> Tuple[StepState, StepOutput]:
    """The eager scan_step over `batches` from `state` on any device, with
    the outputs stacked: the step the compiled step captures, for
    comparisons and profiles against the runners' replays."""
    outs = []
    with torch.no_grad():
        for b in batches:
            state, out = scan_step(state, b, config)
            outs.append(out)
    return state, stack_outputs(outs)


def _start(config: PipelineConfig, state: Optional[StepState], device) -> Tuple[StepState, torch.device]:
    config.validate()
    config.check_ported()
    device = resolve_device(device)
    state = init_state(config, device=device) if state is None else state_to(state, device)
    return state, device


def _scan_at(batches: Union[List[ScanBatch], ScanBatch], i: int) -> ScanBatch:
    if isinstance(batches, ScanBatch):  # stacked along a leading time axis
        return ScanBatch(*[x[i] for x in batches])
    return batches[i]


def _n_scans(batches: Union[List[ScanBatch], ScanBatch]) -> int:
    return int(batches.points.shape[0]) if isinstance(batches, ScanBatch) else len(batches)


def _with_loop(batch: ScanBatch, loop_pose, loop_cov, loop_weight) -> ScanBatch:
    """The batch with its loop-closure channel set to a detected factor."""
    def like(x, v):
        return torch.as_tensor(np.asarray(v), dtype=x.dtype, device=x.device)

    return batch._replace(loop_pose=like(batch.loop_pose, loop_pose), loop_cov=like(batch.loop_cov, loop_cov),
                          loop_weight=like(batch.loop_weight, loop_weight))


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of a value the caller handed in (not counted: the JAX
    package reads the caller's arrays in place)."""
    return x.detach().cpu().numpy()


def _log_live(viewer, i: int, batch: ScanBatch, out: StepOutput, state: StepState, config: PipelineConfig) -> None:
    """Scan i to the live viewer: its stamp and pose read back, the points
    of the caller's batch, and every map_every scans a map snapshot."""
    viewer.log_scan(i, float(COUNTERS.to_host(out.stamp)), COUNTERS.to_host(out.pose),
                    points=_host(batch.points), weights=_host(batch.point_weights),
                    map_valid_total=float(out.tape.map_valid_total))
    if config.with_map:
        viewer.maybe_log_map(i, state.atlas)


def _replay(state: StepState, stacked: ScanBatch, config: PipelineConfig) -> Tuple[StepState, StepOutput]:
    """scan_step over each scan of a device-resident stacked bag."""
    n = _n_scans(stacked)
    loop = StepLoop(config, state, n)
    with torch.no_grad():
        for i in range(n):
            loop.step(_scan_at(stacked, i))
    return loop.result()


def run_bag(
    batches: List[ScanBatch],
    config: PipelineConfig,
    state: Optional[StepState] = None,
    device=None,
) -> Tuple[StepState, StepOutput]:
    """Replay a bag scan by scan on `device` (default: the CUDA card): the
    batches are stacked where they lie and committed to the device in one
    ledger call; a given state is moved there. Host spans run_bag.start,
    run_bag.stack and run_bag.to_device."""
    with span("run_bag.start"):
        state, device = _start(config, state, device)
    with span("run_bag.stack"):
        stacked = stack_scan_batches(batches)
    with span("run_bag.to_device"):
        stacked = COUNTERS.to_device(stacked, device)
    return _replay(state, stacked, config)


def run_scan(
    state0: Optional[StepState],
    stacked_batch: ScanBatch,
    config: PipelineConfig,
    device=None,
) -> Tuple[StepState, StepOutput]:
    """Replay a ScanBatch stacked along a leading time axis (the JAX
    package's whole-bag lax.scan), committed in one ledger call; state0
    None starts from init_state. Host spans run_bag.start and
    run_bag.to_device, as in run_bag."""
    with span("run_bag.start"):
        state, device = _start(config, state0, device)
    with span("run_bag.to_device"):
        stacked = COUNTERS.to_device(stacked_batch, device)
    return _replay(state, stacked, config)


class DeadEndMonitor:
    """Dead-end classification for the status stream (a `dead_end` field in
    each status line), evaluated at status-emission points:
      - ``stalled_pose``: pose displacement below `pose_eps_m` across
        `stall_windows` consecutive status windows WHILE point data is
        flowing (zero-data idling is stream starvation, not a filter stall);
      - ``exploding_triggers``: per-scan certificate trigger count above
        `trigger_ratio` x the running median (a healthy scan fires dozens of
        DECLARED approximation triggers across ops x hypotheses — only a
        departure from the run's own baseline is anomalous);
      - ``zero_ess``: evidence support ESS below `ess_floor` (the filter is
        running on priors only).
    Empty list = healthy.
    """

    def __init__(self, pose_eps_m: float = 0.02, stall_windows: int = 2,
                 trigger_ratio: float = 3.0, ess_floor: float = 1.0,
                 baseline_len: int = 20):
        self.pose_eps_m = pose_eps_m
        self.stall_windows = stall_windows
        self.trigger_ratio = trigger_ratio
        self.ess_floor = ess_floor
        self.baseline_len = baseline_len
        self._last_pose = None
        self._stall_count = 0
        self._trig_hist: list = []

    def update(self, pose_xyz, n_triggers_scan: float, ess_total: float,
               point_weight_sum: float) -> list:
        flags = []
        p = np.asarray(pose_xyz, dtype=float)
        if self._last_pose is not None:
            moved = float(np.linalg.norm(p - self._last_pose))
            if moved < self.pose_eps_m and point_weight_sum > 0.0:
                self._stall_count += 1
            else:
                self._stall_count = 0
            if self._stall_count >= self.stall_windows:
                flags.append("stalled_pose")
        self._last_pose = p
        if len(self._trig_hist) >= 3:
            base = float(np.median(self._trig_hist))
            if n_triggers_scan > self.trigger_ratio * max(base, 1.0):
                flags.append("exploding_triggers")
        self._trig_hist.append(float(n_triggers_scan))
        if len(self._trig_hist) > self.baseline_len:
            self._trig_hist.pop(0)
        if ess_total < self.ess_floor:
            flags.append("zero_ess")
        return flags


def run_stream(
    batches: Union[List[ScanBatch], ScanBatch],
    config: PipelineConfig,
    state: Optional[StepState] = None,
    loop_detector=None,
    map_stream_dir: Optional[str] = None,
    map_stream_every: int = 20,
    status_path: Optional[str] = None,
    status_every: int = 50,
    live_viewer=None,
    device=None,
) -> Tuple[StepState, StepOutput]:
    """The online loop: one scan_step per scan, with host work between steps.

    `loop_detector` (frontend.loop.LoopDetector) enables loop closure:
    before each step it probes the scan against the stored keyframes and a
    detected factor is injected into the batch's loop channel; after each
    step the scan is offered as a keyframe with its pose and, on keyframe
    scans, hypothesis 0's pose covariance.

    `map_stream_dir` enables the incremental map stream: every
    `map_stream_every` scans (and at the last) the atlas is exported as a
    splat snapshot `map_NNNNNN.npz` plus an index line in `map_stream.jsonl`
    (scan index, stamp, splat count, file).

    `status_path` enables the periodic status stream: every `status_every`
    scans (and at the last) a JSON line with the scan counters, pose, map
    size, per-scan trigger count, evidence ESS, non-finite rejection, loop
    weight, DeadEndMonitor flags and wall rate.

    `live_viewer` (outputs.live_view.LiveViewer) enables live
    visualization: each scan's pose, its points every `points_every` scans
    and a map snapshot every `map_every`, from host copies; it is closed at
    the end."""
    from gcslam_torch.outputs.splat_export import save_splat_export

    state, device = _start(config, state, device)
    n = _n_scans(batches)
    stream_idx_f = None
    if map_stream_dir is not None and config.with_map:
        os.makedirs(map_stream_dir, exist_ok=True)
        stream_idx_f = open(os.path.join(map_stream_dir, "map_stream.jsonl"), "w")
    status_f = open(status_path, "w") if status_path is not None else None
    dead_end = DeadEndMonitor() if status_f is not None else None
    t_start = time.time()
    loop = StepLoop(config, state, n)
    pose_prev = np.zeros(6)
    try:
        with torch.no_grad():
            for i in range(n):
                batch = _scan_at(batches, i)
                if loop_detector is not None and i > 0:
                    hit = loop_detector.detect(i, pose_prev, _host(batch.points), _host(batch.point_weights))
                    if hit is not None:
                        batch = _with_loop(batch, *hit)
                state, out = loop.step(COUNTERS.to_device(batch, device))
                if loop_detector is not None:
                    pose_prev = COUNTERS.to_host(out.pose)
                    pose_cov = None
                    if i % loop_detector.cfg.keyframe_every == 0:
                        Sig, _ = linalg.spd_inverse_lifted(Belief(*[x[0] for x in state.beliefs]).L,
                                                           config.eps_lift)
                        pose_cov = COUNTERS.to_host(Sig)[C.IDX_POSE, C.IDX_POSE]
                    loop_detector.store(i, pose_prev, _host(batch.points), _host(batch.point_weights), pose_cov)
                if live_viewer is not None:
                    _log_live(live_viewer, i, batch, out, state, config)
                last = i == n - 1
                if stream_idx_f is not None and (i % map_stream_every == 0 or last):
                    snap = f"map_{i:06d}.npz"
                    n_splats = save_splat_export(os.path.join(map_stream_dir, snap), state.atlas)
                    stream_idx_f.write(json.dumps({
                        "scan": i, "stamp": float(out.stamp), "n_splats": n_splats, "file": snap,
                    }) + "\n")
                    stream_idx_f.flush()
                if status_f is not None and (i % status_every == 0 or last):
                    wall = time.time() - t_start
                    tape = out.tape
                    pose_xyz = COUNTERS.to_host(out.pose)[:3]
                    n_trig = float(tape.cert_n_triggers)
                    ess = float(tape.support_ess_total)
                    status_f.write(json.dumps({
                        "scan": i,
                        "stamp": float(COUNTERS.to_host(out.stamp)),
                        "pose_xyz": [round(float(x), 4) for x in pose_xyz],
                        "map_valid_total": float(tape.map_valid_total),
                        "n_triggers_scan": n_trig,
                        "ess_total": round(ess, 3),
                        # the NonFiniteEvidence trigger bit, not cert_exact:
                        # exact is 0 whenever any declared approximation ran
                        "nonfinite_rejected": bool(int(tape.cert_triggers) & TRIGGERS["NonFiniteEvidence"]),
                        "loop_weight": float(tape.io_loop_weight),
                        "dead_end": dead_end.update(pose_xyz, n_trig, ess, float(tape.io_point_weight_sum)),
                        "wall_s": round(wall, 3),
                        "scans_per_s": round((i + 1) / max(wall, 1e-9), 2),
                    }) + "\n")
                    status_f.flush()
    finally:
        for f in (stream_idx_f, status_f, live_viewer):
            if f is not None:
                f.close()
    return loop.result()


def run_chunked(
    batches: Union[List[ScanBatch], ScanBatch],
    config: PipelineConfig,
    chunk: int = 10,
    state: Optional[StepState] = None,
    loop_detector=None,
    live_viewer=None,
    device=None,
) -> Tuple[StepState, StepOutput]:
    """Windows of `chunk` scans with loop closure at the window boundaries
    (the JAX package's live mode: one device program per window there).

    After each full window the detector stores the window's keyframe scans
    (with their poses, no pose covariance) and probes the next window's
    first scan from the window's last pose; a factor it finds is merged
    into that first scan's loop channel only when its weight is > 0 (a
    weight-0 factor leaves the channel the replay carries). The
    len % chunk remaining scans run scan by scan without loop work, as in
    the reference runner — a factor probed for the first of them is
    dropped. `batches` may be a list or a ScanBatch stacked along a leading
    time axis. `live_viewer` logs every scan as run_stream's does (the JAX
    package's run_chunked takes none, and its eval.run drops --live-view
    under --chunk); it is closed at the end. Host spans run_chunked.start,
    run_chunked.stack and run_chunked.to_device (the windows' commit and
    each remainder scan's), and at each full window's end
    run_chunked.poses (the window's poses read back: the host waits for
    the device there) and run_chunked.loop (the detector's calls)."""
    with span("run_chunked.start"):
        state, device = _start(config, state, device)
    n = _n_scans(batches)
    n_full = (n // chunk) * chunk
    if n_full:
        with span("run_chunked.stack"):
            head = (ScanBatch(*[x[:n_full] for x in batches]) if isinstance(batches, ScanBatch)
                    else stack_scan_batches(batches[:n_full]))
        with span("run_chunked.to_device"):
            windows = COUNTERS.to_device(head, device)
    loop = StepLoop(config, state, n)
    outs = loop.outs
    pending = None
    try:
        with torch.no_grad():
            for c in range(0, n_full, chunk):
                for i in range(c, c + chunk):
                    batch = _scan_at(windows, i)
                    if i == c and pending is not None and pending[2] > 0:
                        batch = _with_loop(batch, *pending)
                    state, out = loop.step(batch)
                    if live_viewer is not None:
                        _log_live(live_viewer, i, _scan_at(batches, i), out, state, config)
                pending = None
                if loop_detector is not None:
                    with span("run_chunked.poses"):
                        poses = COUNTERS.to_host(torch.stack([o.pose for o in outs[c:c + chunk]]))
                    with span("run_chunked.loop"):
                        for j in range(chunk):
                            i = c + j
                            if i % loop_detector.cfg.keyframe_every:
                                continue  # store() drops non-keyframes
                            b = _scan_at(batches, i)
                            loop_detector.store(i, poses[j], _host(b.points), _host(b.point_weights), None)
                        if c + chunk < n:
                            nb = _scan_at(batches, c + chunk)
                            pending = loop_detector.detect(c + chunk, poses[-1], _host(nb.points),
                                                           _host(nb.point_weights))
            for i in range(n_full, n):
                batch = _scan_at(batches, i)
                with span("run_chunked.to_device"):
                    staged = COUNTERS.to_device(batch, device)
                state, out = loop.step(staged)
                if live_viewer is not None:
                    _log_live(live_viewer, i, batch, out, state, config)
    finally:
        if live_viewer is not None:
            live_viewer.close()
    return loop.result()
