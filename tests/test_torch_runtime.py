"""The port's transfer ledger (utils/profiling) against the JAX package's.

  - the device-runtime contract of tests/test_runtime_contracts.py:18-41
    on the port: run_bag makes one host-to-device commit and no host sync
    or read back before the caller gathers its outputs;
  - run_bag, run_stream (loop detector, status stream and a live viewer)
    and run_chunked (loop detector, a remainder) count the same calls,
    bytes and syncs as the JAX runners on the same numpy inputs. The
    ledger is the runners' host logic, so the JAX side's jitted device
    programs (_step_jit, run_scan, _chunk_jit) are stand-ins that return
    outputs of the real shapes and dtypes: compiling the JAX pipeline for
    the three runners would take about a minute on the CPU;
  - eval.run writes the ledger into metrics.json's device_runtime beside
    the device inventory (the bag run against the JAX package's is in
    tests/test_torch_eval.py);
  - models/manifest.compute_cert measured on one call;
  - StepTimer.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcslam_tpu.frontend import loop as jloop
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models import runner as jrunner
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.models.scan_step import ScanTape as JTape, StepOutput as JOut
from gcslam_tpu.utils.profiling import COUNTERS as JCOUNTERS
from gcslam_torch.eval import run as trun
from gcslam_torch.frontend import loop as tloop
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import manifest, runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import FIELD_DTYPES, ScanBatch, batch_from_numpy
from gcslam_torch.models.scan_step import init_state, scan_step
from gcslam_torch.utils.profiling import COUNTERS, StepTimer
from gcslam_torch.utils.tree import tree_leaves
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

# tests/test_runtime_contracts.py's budgets
SMALL = dict(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
N_SCANS, N_POINTS, CHUNK = 5, 256, 2
# a loop detector that stores every scan and probes every one (no firing
# needed: the ledger counts the same bytes whether a factor is injected)
LOOP = dict(keyframe_every=1, min_index_gap=2, max_revisit_dist_m=3.0, cooldown_scans=1)
LEDGER_KEYS = ("h2d_bytes", "h2d_calls", "d2h_bytes", "host_syncs")
# the JAX ledger's key with no counterpart in the port (eager PyTorch has
# no jit cache), and the port's in its place
JAX_ONLY_LEDGER = {"jit_cache_entries"}
PORT_ONLY_LEDGER = {"native_builds"}


@pytest.fixture(scope="module")
def jrun():
    return jgenerate(JSynth(n_scans=N_SCANS, n_points=N_POINTS))


@pytest.fixture(scope="module")
def tbatches(jrun):
    return [batch_from_numpy(jax.tree_util.tree_map(np.asarray, b), device="cpu") for b in jrun.batches]


def test_replay_host_sync_absence():
    """tests/test_runtime_contracts.py:18-41 on the port: one h2d commit (the
    stacked bag), no host sync and no read back until the caller gathers;
    the gather is the first d2h."""
    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS), device="cpu")
    COUNTERS.reset()
    _, out = runner.run_bag(run.batches, cfg, device="cpu")
    assert COUNTERS.h2d_calls == 1
    assert COUNTERS.h2d_bytes == sum(x.nbytes for b in run.batches for x in b)
    assert COUNTERS.d2h_bytes == 0
    assert COUNTERS.host_syncs == 0
    pose = COUNTERS.to_host(out.pose)
    assert COUNTERS.host_syncs == 1
    assert COUNTERS.d2h_bytes == pose.nbytes
    assert np.all(np.isfinite(pose))


def test_scan_batch_dtypes_agree(jrun):
    """Every ScanBatch field has the JAX package's dtype, so h2d_bytes can be
    held to the JAX ledger in the tests below (no field differs)."""
    differ = {f: (str(getattr(jrun.batches[0], f).dtype), str(FIELD_DTYPES[f])) for f in ScanBatch._fields
              if np.dtype(getattr(jrun.batches[0], f).dtype).itemsize != torch.empty((), dtype=FIELD_DTYPES[f])
              .element_size()}
    assert not differ


def _fake_out(batch):
    """A StepOutput of the real step's shapes and dtypes for one scan or a
    stack of them (pose from the scans' odometry; the tape's scalars 0)."""
    return JOut(pose=batch.odom_pose, stamp=batch.t_scan,
                tape=JTape(*[jnp.zeros(batch.t_scan.shape) for _ in JTape._fields]))


@pytest.fixture
def jax_stand_ins(monkeypatch):
    """The JAX runners with their device programs replaced by stand-ins."""
    monkeypatch.setattr(jrunner, "_step_jit", lambda s, b, config: (s, _fake_out(b)))
    monkeypatch.setattr(jrunner, "run_scan", lambda s, b, config: (s, _fake_out(b)))

    def chunk(s, windows, c, lp, lc, lw, config):
        w = jax.tree_util.tree_map(lambda x: x[c], windows)
        return s, _fake_out(w)

    monkeypatch.setattr(jrunner, "_chunk_jit", chunk)


class _Viewer:
    """A live viewer that keeps nothing (both runners call the same three
    methods)."""

    def log_scan(self, *args, **kwargs):
        pass

    def maybe_log_map(self, *args):
        pass

    def close(self):
        pass


def _runs(mode, tmp_path):
    """(JAX call, port call) of one runner mode; each returns its outputs."""
    jcfg, tcfg = JConfig(**SMALL), PipelineConfig(**SMALL)
    if mode == "run_bag":
        return (lambda b: jrunner.run_bag(b, jcfg), lambda b: runner.run_bag(b, tcfg, device="cpu"))
    if mode == "run_stream":
        def kw(pkg_loop, name):
            return dict(loop_detector=pkg_loop.LoopDetector(pkg_loop.LoopConfig(**LOOP)), live_viewer=_Viewer(),
                        status_path=str(tmp_path / f"{name}.jsonl"), status_every=2)
        return (lambda b: jrunner.run_stream(b, jcfg, **kw(jloop, "jax")),
                lambda b: runner.run_stream(b, tcfg, device="cpu", **kw(tloop, "torch")))
    return (lambda b: jrunner.run_chunked(b, jcfg, chunk=CHUNK, loop_detector=jloop.LoopDetector(
                jloop.LoopConfig(**LOOP))),
            lambda b: runner.run_chunked(b, tcfg, chunk=CHUNK, device="cpu",
                                         loop_detector=tloop.LoopDetector(tloop.LoopConfig(**LOOP))))


@pytest.mark.parametrize("mode", ["run_bag", "run_stream", "run_chunked"])
def test_ledger_matches_jax(mode, jrun, tbatches, jax_stand_ins, tmp_path):
    """The same calls, bytes and syncs as the JAX runner on the same inputs;
    run_bag reads nothing back, the others read poses (and run_stream the
    keyframes' pose covariances, the status stream's and the live view's
    poses and stamps) through the ledger."""
    jcall, tcall = _runs(mode, tmp_path)
    JCOUNTERS.reset()
    jcall(jrun.batches)
    COUNTERS.reset()
    _, out = tcall(tbatches)
    jc, tc = JCOUNTERS.cert(), COUNTERS.cert()
    assert set(tc) == set(jc) - JAX_ONLY_LEDGER | PORT_ONLY_LEDGER
    assert {k: tc[k] for k in LEDGER_KEYS} == {k: jc[k] for k in LEDGER_KEYS}
    expected_calls = {"run_bag": 1, "run_stream": N_SCANS, "run_chunked": 1 + N_SCANS % CHUNK}[mode]
    assert tc["h2d_calls"] == expected_calls
    assert (tc["d2h_bytes"] > 0) == (mode != "run_bag") and tc["host_syncs"] >= (mode != "run_bag")
    assert torch.isfinite(out.pose).all()


def test_eval_run_writes_the_ledger(tmp_path):
    """eval.run (synthetic rig, run_bag) resets the ledger and writes it into
    metrics.json's device_runtime beside the device inventory: one commit,
    the poses and stamps read back with one sync each, no XLA counter."""
    cfg_path = tmp_path / "small.json"
    cfg_path.write_text(json.dumps(dict(SMALL, odom_pose_mode="absolute", with_camera=False)))
    COUNTERS.reset()
    COUNTERS.to_host(torch.zeros(3))  # before the run: must not show
    metrics = trun.main(["--cpu", "--scans", "3", "--points", str(N_POINTS), "--config", str(cfg_path),
                         "--out", str(tmp_path / "out")])
    on_disk = json.load(open(os.path.join(tmp_path / "out", "metrics.json")))
    drt = on_disk["device_runtime"]
    assert drt == metrics["device_runtime"]
    assert {"platform", "n_devices", "device_kinds"} <= set(drt)
    assert drt["h2d_calls"] == 1 and drt["h2d_bytes"] > 0
    assert drt["host_syncs"] == 2 and drt["d2h_bytes"] == 3 * 6 * 8 + 3 * 8
    assert drt["native_builds"] >= 0
    assert not {"run_scan_compiles", "step_compiles", "jit_cache_entries", "x64_enabled",
                "compilation_cache_entries"} & set(drt)


def test_compute_cert_counts_one_call():
    """matmul_flops is FlopCounterMode's count (2 m n k for a product), the
    argument and output bytes are the tensors', peak memory is None off the
    card; on the step the call's result is the plain call's."""
    a, b = torch.randn(8, 16, dtype=torch.float64), torch.randn(16, 4, dtype=torch.float64)
    cert, out = manifest.compute_cert(lambda x, y: (x @ y).exp(), a, b)
    assert cert == {"matmul_flops": 2 * 8 * 16 * 4, "argument_bytes": a.nbytes + b.nbytes,
                    "output_bytes": out.nbytes, "peak_allocated_bytes": None, "peak_above_start_bytes": None}
    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=1, n_points=N_POINTS), device="cpu")
    state = init_state(cfg, device="cpu")
    with torch.no_grad():
        cert, (s1, o1) = manifest.compute_cert(lambda s, bt: scan_step(s, bt, cfg), state, run.batches[0])
        _, o2 = scan_step(init_state(cfg, device="cpu"), run.batches[0], cfg)
    assert cert["matmul_flops"] > 0 and cert["output_bytes"] > 0
    assert cert["argument_bytes"] == sum(x.nbytes for x in tree_leaves([state, run.batches[0]]))
    assert torch.equal(o1.pose, o2.pose)


def test_step_timer_summary():
    timer = StepTimer()
    for _ in range(4):
        with timer.measure(out_ref=torch.zeros(2)):
            pass
    s = timer.summary()
    assert set(s) == {"n", "mean_ms", "p50_ms", "p95_ms", "max_ms"} and s["n"] == 4
    assert StepTimer().summary() == {}
