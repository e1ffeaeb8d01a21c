"""The compiled step's CPU guards (gcslam_torch/models/runner.py):

  - a scan_step after the first makes no call that copies a value between
    the host and the device (torch.tensor, torch.as_tensor, .item(),
    .tolist(), .numpy(), float() / int() / bool() of a tensor), so nothing
    in it synchronizes with the card and nothing of its data is frozen
    into a captured CUDA graph; and every symmetric eigendecomposition in
    it goes through ops/eigh;
  - the compiled step's body (static state and batch buffers, the new
    state copied into the state buffers, each scan's outputs copied into
    the run's stacked outputs), run without capture on the CPU, gives
    run_bag's eager poses, tape and final state bit for bit;
  - the graph cache keeps MAX_GRAPHS steps, least recently used out first;
  - a launch counter's capture counts move to every replay;
  - the stage clock (host stamps on the CPU) times the body's nine stages
    and changes no output; the host spans count each scan and call; the
    stage ranges show in a CPU profiler trace, and a profiled call leaves
    the clock's and the spans' totals as they were;
  - run_chunked's host spans: one run_chunked.start, .stack a call, one
    run_chunked.poses and .loop a full window, one .to_device for the
    windows and one for each remainder scan; its poses, tapes, final state
    and loop-detector calls bit-equal with the spans and without them.
"""

import collections
import time
import traceback

import pytest
import torch
from torch.overrides import TorchFunctionMode

from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import stack_scan_batches
from gcslam_torch.models.scan_step import init_state, scan_step
from gcslam_torch.ops.cuda_build import LaunchCounter
from gcslam_torch.utils.tree import tree_leaves

SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
             surfel_voxel_size_m=0.5)
HOST_VALUES = {torch.tensor, torch.as_tensor, torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
               torch.Tensor.__float__, torch.Tensor.__int__, torch.Tensor.__bool__, torch.Tensor.__index__}
EIGEN = {torch.linalg.eigh, torch.linalg.eigvalsh, torch.linalg.eig, torch.linalg.eigvals, torch.linalg.svd}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return generate(SyntheticConfig(n_scans=5, n_points=512), device="cpu")


class CallSites(TorchFunctionMode):
    """The Python file:line that called each watched torch function."""

    def __init__(self, watched):
        super().__init__()
        self.watched = watched
        self.sites = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.watched:
            frame = traceback.extract_stack()[-2]
            self.sites[(func.__name__, f"{frame.filename}:{frame.lineno}")] += 1
        return func(*args, **(kwargs or {}))


def test_a_second_step_moves_no_value_between_host_and_device(world):
    cfg = PipelineConfig(**SMALL)
    with torch.no_grad():
        state, _ = scan_step(init_state(cfg, device="cpu"), world.batches[0], cfg)  # makes the constant caches
        probe = CallSites(HOST_VALUES)
        with probe:
            torch.tensor([1.0])  # the mode does see these calls
        assert sum(probe.sites.values()) == 1
        host, eigen = CallSites(HOST_VALUES), CallSites(EIGEN)
        with host, eigen:
            scan_step(state, world.batches[1], cfg)
    assert not host.sites, dict(host.sites)
    assert eigen.sites and all(site.replace("\\", "/").rsplit(":", 1)[0].endswith("gcslam_torch/ops/eigh.py")
                               for _, site in eigen.sites), dict(eigen.sites)


def test_compiled_body_equals_eager_run_bag(world):
    cfg = PipelineConfig(**SMALL)
    state_e, out_e = runner.run_bag(world.batches, cfg, device="cpu")
    stacked = stack_scan_batches(world.batches)
    state0 = init_state(cfg, device="cpu")
    loop = runner.StepLoop(cfg, state0, 5)  # on the CPU the eager step: give it the body without capture
    loop.use_compiled, loop.compiled = True, runner.CompiledStep(cfg, state0, world.batches[0], capture=False)
    with torch.no_grad():
        for i in range(5):
            live, out_i = loop.step(runner._scan_at(stacked, i))
            assert live is loop.compiled.state  # the state buffers, updated in place
            assert torch.equal(out_i.pose, loop.stacked[0][i])  # a row of the stacked outputs
    state_c, out_c = loop.result()
    assert loop.compiled.graph is None and isinstance(out_c.tape, type(out_e.tape))
    for a, b in zip(tree_leaves(out_e), tree_leaves(out_c)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(state_e), tree_leaves(state_c)):
        assert torch.equal(a, b)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(tree_leaves(state_c), tree_leaves(loop.compiled.state)))


def test_graph_cache_keeps_the_most_recent_steps(world):
    runner.release_graphs()
    batch = world.batches[0]
    states = {}
    for k in (1, 2, 3):
        cfg = PipelineConfig(with_map=False, k_hyp=k)
        states[k] = init_state(cfg, device="cpu")
        step = runner.compiled_step(cfg, states[k], batch)
        assert step.graph is None and step.config == cfg
    assert [s.config.k_hyp for s in runner.compiled_steps()] == [3 - runner.MAX_GRAPHS + 1 + i
                                                                 for i in range(runner.MAX_GRAPHS)]
    cfg3 = PipelineConfig(with_map=False, k_hyp=3)
    again = runner.compiled_step(cfg3, states[3]._replace(scan_count=states[3].scan_count + 7), batch)
    assert again is runner.compiled_steps()[-1] and int(again.state.scan_count) == 7  # reloaded in place
    runner.release_graphs()
    assert runner.compiled_steps() == []


def test_launch_counter_moves_capture_counts_to_replays():
    c = LaunchCounter()
    c.count((1, 1024, 8), torch.float64)
    saved = c.snapshot()
    c.reset()
    c.count((2, 22, 22), torch.float32)  # what a capture records
    c.count((2, 22, 22), torch.float32)
    captured = c.snapshot()
    c.restore(saved)
    assert (c.launches, c.shapes) == (1, {(1, 1024, 8)})
    for _ in range(3):  # three replays
        c.add(captured)
    assert c.launches == 7 and c.by_instance == {("float64", (1, 1024, 8)): 1, ("float32", (2, 22, 22)): 6}
    assert c.shapes == {(1, 1024, 8), (2, 22, 22)}
    LaunchCounter.instances.remove(c)


def test_stage_clock_times_the_nine_stages_and_changes_no_output(world):
    """The compiled body with its stage clock (host stamps on the CPU): the
    nine stages in order, each > 0, summing to the step loop's host time
    within 10 %; poses, tapes and state bit-equal to the body without the
    clock and to the eager run_bag; the host spans count one step.launch and
    one step.outputs a scan, and one of each run_bag span a call."""
    from gcslam_torch.utils.profiling import SPANS, STAGES

    cfg = PipelineConfig(**SMALL)
    batches = world.batches[:3]
    SPANS.reset()
    eager = runner.run_bag(batches, cfg, device="cpu")
    assert dict(SPANS.calls) == {"run_bag.start": 1, "run_bag.stack": 1, "run_bag.to_device": 1}
    stacked = stack_scan_batches(batches)
    results, host_ns = {}, 0
    for with_clock in (True, False):
        state0 = init_state(cfg, device="cpu")
        loop = runner.StepLoop(cfg, state0, 3)
        loop.use_compiled = True
        loop.compiled = runner.CompiledStep(cfg, state0, batches[0], capture=False, stage_clock=with_clock)
        with torch.no_grad():
            for i in range(3):
                t0 = time.perf_counter_ns()
                loop.step(runner._scan_at(stacked, i))
                host_ns += (time.perf_counter_ns() - t0) * with_clock
        results[with_clock] = loop.result()
        if with_clock:
            reading = loop.compiled.stage_clock.read()
        else:
            assert loop.compiled.stage_clock is None
    assert SPANS.calls["step.launch"] == SPANS.calls["step.outputs"] == 6
    assert list(reading.ms_per_scan) == list(STAGES) and reading.scans == 3
    assert all(v > 0 for v in reading.stage_ns.values()), reading
    assert 0.9 * host_ns <= sum(reading.stage_ns.values()) <= host_ns
    assert 0 < reading.between_share < 0.1  # two gaps between three steps: the output copy and the staging
    for a, b, c in zip(tree_leaves(results[True]), tree_leaves(results[False]), tree_leaves(eager)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_stage_clock_arithmetic():
    """The stamp kernel's arithmetic on the host: a stage the step skips
    reads 0, the time before a call's first step is not between steps, and
    the time between two steps of one call is."""
    from gcslam_torch.utils.profiling import STAGES, StageClock, _accumulate

    clock = StageClock("cpu")
    n, c = len(STAGES), clock._host
    for mark, now in [(0, 100), (1, 110), (4, 150), (n - 1, 190), (n, 200), (0, 230), (n - 1, 260), (n, 275)]:
        _accumulate(c, mark, now)
    got = clock.read()
    assert got.stage_ns == dict(zip(STAGES, [10 + 30, 40, 0, 0, 40, 0, 0, 0, 10 + 15]))
    assert got.scans == 2 and got.between_ns == 30 and got.between_share == 30 / (100 + 45 + 30)
    clock.begin_call()
    _accumulate(c, 0, 1000)
    assert clock.read().between_ns == 30
    clock.reset()
    assert clock.read() == type(got)(dict.fromkeys(STAGES, 0), 0, 0)


def test_stage_ranges_in_a_cpu_trace(world):
    """One step of the compiled body under torch.profiler on the CPU: the
    nine gcslam.stage.<name> ranges in order, inside the host span
    gcslam.step.launch; the profiled call leaves the stage clock and the
    host spans' totals as they were (they count untraced runs)."""
    from gcslam_torch.utils import cuda_profile
    from gcslam_torch.utils.profiling import SPANS, STAGES

    cfg = PipelineConfig(**SMALL)
    state0 = init_state(cfg, device="cpu")
    loop = runner.StepLoop(cfg, state0, 2)
    loop.use_compiled = True
    loop.compiled = runner.CompiledStep(cfg, state0, world.batches[0], capture=False)
    clock = loop.compiled.stage_clock
    with torch.no_grad():
        loop.step(world.batches[0])
        before, calls = clock.read(), dict(SPANS.calls)

        def profiled_call():
            clock.begin_call()
            loop.step(world.batches[1])
            loop.result()

        prof, _ = cuda_profile.profile(profiled_call, ("cpu",))
    assert before.scans == 1 and clock.read() == before and dict(SPANS.calls) == calls
    events = sorted(cuda_profile.raw_events(prof), key=lambda e: e.start_ns())
    ranges = [e for e in events if e.name().startswith("gcslam.")]
    launch = [e for e in ranges if e.name() == "gcslam.step.launch"]
    stages = [e for e in ranges if e.name().startswith("gcslam.stage.")]
    assert [e.name() for e in stages] == [f"gcslam.stage.{s}" for s in STAGES] and len(launch) == 1
    lo, hi = launch[0].start_ns(), launch[0].start_ns() + launch[0].duration_ns()
    assert all(lo <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi for e in stages)


def _chunked(batches, cfg):
    """run_chunked(chunk=2) with a loop detector that keeps every second
    scan; returns (final state, outputs, the detector's calls)."""
    from gcslam_torch.frontend.loop import LoopConfig, LoopDetector

    calls = []

    class Recording(LoopDetector):
        def store(self, index, pose_est, points, weights, pose_cov=None):
            calls.append(("store", index, pose_est.copy()))
            return super().store(index, pose_est, points, weights, pose_cov)

        def detect(self, index, pose_guess, points, weights):
            hit = super().detect(index, pose_guess, points, weights)
            calls.append(("detect", index, pose_guess.copy(), hit))
            return hit

    det = Recording(LoopConfig(keyframe_every=2, min_index_gap=2))
    state, out = runner.run_chunked(batches, cfg, chunk=2, loop_detector=det, device="cpu")
    return state, out, calls


def test_run_chunked_spans_count_calls_and_windows(world):
    """Two calls of run_chunked(chunk=2) over 5 scans (2 full windows and a
    remainder scan): one run_chunked.start and .stack a call, one
    run_chunked.poses and .loop a full window, and .to_device once for the
    windows and once for the remainder scan."""
    from gcslam_torch.utils.profiling import SPANS

    cfg = PipelineConfig(**SMALL)
    SPANS.reset()
    for calls in (1, 2):
        _chunked(world.batches, cfg)
        assert dict(SPANS.calls) == {"run_chunked.start": calls, "run_chunked.stack": calls,
                                     "run_chunked.to_device": 2 * calls, "run_chunked.poses": 2 * calls,
                                     "run_chunked.loop": 2 * calls}
    assert all(SPANS.seconds[k] > 0 for k in SPANS.calls)


def test_run_chunked_outputs_are_the_same_without_spans(world, monkeypatch):
    """run_chunked's poses, tapes, final state and loop-detector calls with
    the host spans and with every span a no-op, bit for bit."""
    import contextlib

    import numpy as np

    cfg = PipelineConfig(**SMALL)
    on = _chunked(world.batches, cfg)
    monkeypatch.setattr(runner, "span", lambda name: contextlib.nullcontext())
    off = _chunked(world.batches, cfg)
    for a, b in zip(tree_leaves(on[:2]), tree_leaves(off[:2])):
        assert torch.equal(a, b)
    assert [c[:2] for c in on[2]] == [c[:2] for c in off[2]] and len(on[2]) == 4
    for a, b in zip(on[2], off[2]):
        assert np.array_equal(a[2], b[2]) and (a[0] == "store" or (a[3] is None) == (b[3] is None))
