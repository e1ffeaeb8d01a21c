"""The port's run loops, loop-closure detector and checkpoints.

  - run_scan, run_stream and run_chunked are the same scan_step sequence as
    run_bag with other host work between steps: with no loop detector they
    equal run_bag bit for bit, from a list and from a stacked ScanBatch
    (10 scans at chunk 4 include the scan-by-scan remainder);
  - the DeadEndMonitor and the status / map streams (tests/test_dead_end.py
    and tests/test_outputs.py on the port);
  - the port's LoopDetector is the JAX package's numpy code: the same calls
    give the same results exactly; loop factors through run_bag,
    run_stream and run_chunked behave as in the JAX package on the same
    worlds (with_map=False, where the two packages' poses agree to 1e-9:
    tests/test_torch_slice.py::test_no_map_run_bag);
  - checkpoints round-trip and cross between the packages in both
    directions.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.frontend import loop as jloop
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models import runner as jrunner
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.models.scan_step import init_state as jinit_state
from gcslam_tpu.utils import checkpoint as jckpt
from gcslam_torch.frontend import loop as tloop
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner, scan_step as tstep
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import batch_from_numpy, stack_scan_batches
from gcslam_torch.utils import checkpoint as tckpt
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_slice import SMALL, np_tree

NO_MAP_POSE_ATOL = 1e-9  # with_map=False: the packages agree to ~1e-12 (test_torch_slice)


@pytest.fixture(scope="module")
def tbatches():
    return generate(SyntheticConfig(n_scans=10, n_points=512), device="cpu").batches


@pytest.fixture(scope="module")
def reference(tbatches):
    return runner.run_bag(tbatches, PipelineConfig(**SMALL), device="cpu")


RUNNERS = {
    "run_scan": lambda b, cfg: runner.run_scan(None, b, cfg, device="cpu"),
    "run_stream": lambda b, cfg: runner.run_stream(b, cfg, device="cpu"),
    "run_chunked": lambda b, cfg: runner.run_chunked(b, cfg, chunk=4, device="cpu"),
}
CASES = [("run_scan", True), ("run_stream", False), ("run_stream", True), ("run_chunked", False),
         ("run_chunked", True)]


@pytest.mark.parametrize("mode,stacked", CASES, ids=[f"{d}-{'stacked' if s else 'list'}" for d, s in CASES])
def test_run_modes_equal_run_bag(tbatches, reference, mode, stacked):
    state0, out0 = reference
    batches = stack_scan_batches(tbatches) if stacked else tbatches
    state, out = RUNNERS[mode](batches, PipelineConfig(**SMALL))
    assert out.pose.shape == out0.pose.shape
    assert torch.equal(out.pose, out0.pose) and torch.equal(out.stamp, out0.stamp)
    for a, b in zip(out.tape, out0.tape):
        assert torch.equal(a, b)
    for a, b in zip(tckpt.state_leaves(state), tckpt.state_leaves(state0)):
        assert torch.equal(a, b)


# --- dead-end monitor and the status / map streams -------------------------


def test_monitor_unit_flags():
    m = runner.DeadEndMonitor(pose_eps_m=0.02, stall_windows=2, trigger_ratio=3.0, ess_floor=1.0)
    assert m.update([0.0, 0, 0], 70.0, 50.0, 100.0) == []
    assert m.update([0.5, 0, 0], 72.0, 50.0, 100.0) == []
    assert m.update([0.5, 0, 0], 71.0, 50.0, 100.0) == []
    assert "stalled_pose" in m.update([0.5001, 0, 0], 70.0, 50.0, 100.0)
    assert "stalled_pose" not in m.update([1.5, 0, 0], 72.0, 50.0, 100.0)
    flags = m.update([2.5, 0, 0], 400.0, 0.1, 100.0)
    assert "exploding_triggers" in flags and "zero_ess" in flags
    m3 = runner.DeadEndMonitor()
    for k in range(6):
        assert "exploding_triggers" not in m3.update([k * 1.0, 0, 0], 500.0, 50.0, 100.0)
    m2 = runner.DeadEndMonitor(stall_windows=1)
    m2.update([0, 0, 0], 0.0, 50.0, 0.0)
    assert "stalled_pose" not in m2.update([0, 0, 0], 0.0, 50.0, 0.0)


def test_stalled_filter_fires_in_status_stream(tmp_path):
    """Odometry frozen at the origin while LiDAR data keeps flowing: the
    status stream raises the stall flag on later lines, not on the first."""
    run = generate(SyntheticConfig(n_scans=8, n_points=256), device="cpu")
    stall_cov = 1e-4 * torch.eye(6, dtype=torch.float64)
    batches = [b._replace(odom_pose=b.odom_pose * 0.0, odom_rel_pose=b.odom_rel_pose * 0.0,
                          odom_cov=stall_cov, odom_rel_cov=stall_cov, odom_twist=b.odom_twist * 0.0)
               for b in run.batches]
    status = tmp_path / "status.jsonl"
    runner.run_stream(batches, PipelineConfig(with_map=False), status_path=str(status), status_every=1,
                      device="cpu")
    lines = [json.loads(l) for l in status.read_text().splitlines()]
    assert len(lines) == len(batches)
    assert all("dead_end" in l for l in lines)
    assert any("stalled_pose" in l["dead_end"] for l in lines[2:])
    assert "stalled_pose" not in lines[0]["dead_end"]


def test_map_and_status_streams(tmp_path):
    """Map snapshots every 3 scans and at the last (tests/test_outputs.py's
    case), status lines every 2 scans and at the last; both parse."""
    run = generate(SyntheticConfig(n_scans=7, n_points=256), device="cpu")
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64,
                         surfel_voxel_size_m=0.5)
    d = tmp_path / "stream"
    status = tmp_path / "status.jsonl"
    state, out = runner.run_stream(run.batches, cfg, map_stream_dir=str(d), map_stream_every=3,
                                   status_path=str(status), status_every=2, device="cpu")
    lines = [json.loads(l) for l in (d / "map_stream.jsonl").read_text().splitlines()]
    assert [e["scan"] for e in lines] == [0, 3, 6]
    last = np.load(d / lines[-1]["file"])
    assert lines[-1]["n_splats"] > 0 and last["mu_world"].shape[0] == lines[-1]["n_splats"]
    st = [json.loads(l) for l in status.read_text().splitlines()]
    assert [e["scan"] for e in st] == [0, 2, 4, 6]
    assert st[-1]["map_valid_total"] == float(out.tape.map_valid_total[-1])
    assert st[-1]["pose_xyz"] == [round(float(x), 4) for x in out.pose[-1, :3]]
    assert not any(e["nonfinite_rejected"] for e in st) and all(e["loop_weight"] == 0.0 for e in st)


# --- the loop-closure detector ----------------------------------------------


def _scene(kind, n=600, seed=0):
    """tests/test_loop.py's structured clouds: a corridor or a room."""
    rng = np.random.default_rng(seed)
    if kind == "corridor":
        return np.c_[rng.uniform(-6, 6, n), np.where(rng.random(n) < 0.5, -1.5, 1.5) + rng.normal(0, 0.03, n),
                     rng.uniform(0, 2.5, n)]
    t, side = rng.uniform(0, 4, n), rng.integers(0, 5, n)
    x = np.select([side == 0, side == 1, side == 2, side == 3, side == 4],
                  [t - 2, t - 2, np.full(n, -2.0), np.full(n, 2.0), rng.normal(0.8, 0.1, n)])
    y = np.select([side == 0, side == 1, side == 2, side == 3, side == 4],
                  [np.full(n, -2.0), np.full(n, 2.0), t - 2, t - 2, rng.normal(-0.5, 0.1, n)])
    return np.c_[x, y, np.where(side == 4, rng.uniform(0, 4.0, n), rng.uniform(0, 2.0, n))]


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_loop_detector_equals_the_jax_one():
    """The same store/detect sequence through both detectors: identical
    factors (or None) and identical keyframe stores, bit for bit."""
    cfg = dict(keyframe_every=1, min_index_gap=2, max_revisit_dist_m=5.0, cooldown_scans=0)
    dets = [jloop.LoopDetector(jloop.LoopConfig(**cfg)), tloop.LoopDetector(tloop.LoopConfig(**cfg))]
    corridor, room = _scene("corridor", seed=1), _scene("room", seed=2)
    w = np.ones(corridor.shape[0])
    w[::7] = 0.0
    rng = np.random.default_rng(5)
    calls = [("store", 0, np.zeros(6), corridor, np.diag([1e-4] * 6)),
             ("store", 1, np.array([0.3, 0.1, 0, 0, 0, 0.05]), room, None),
             ("detect", 10, np.array([0.2, 0.1, 0, 0, 0, 0.1]), room),
             ("detect", 20, np.array([0.1, 0.0, 0, 0, 0, 0.02]), corridor),
             ("detect", 30, np.array([4.0, 4.0, 0, 0, 0, 0.0]), corridor),
             ("detect", 40, np.array([0.05, 0.2, 0, 0, 0, -0.04]), corridor + rng.normal(0, 0.02, corridor.shape))]
    results = [[], []]
    for call in calls:
        for det, res in zip(dets, results):
            if call[0] == "store":
                det.store(call[1], call[2], call[3], w, call[4])
            else:
                res.append(det.detect(call[1], call[2], call[3], w))
    assert any(r is not None for r in results[0]) and any(r is None for r in results[0])
    assert all(_same(a, b) for a, b in zip(*results))
    for ka, kb in zip(dets[0].keyframes, dets[1].keyframes):
        assert ka.index == kb.index and np.array_equal(ka.points_body, kb.points_body)
        assert np.array_equal(ka.descriptor, kb.descriptor) and _same([ka.pose_cov], [kb.pose_cov])
    # registration alone, from an offset guess
    kf = tloop.Keyframe(index=0, pose=np.array([1.0, 0.5, 0, 0, 0, 0.3]), points_body=corridor)
    jkf = jloop.Keyframe(index=0, pose=kf.pose, points_body=corridor)
    guess = np.array([1.1, 0.45, 0, 0, 0, 0.35])
    assert _same(dets[0]._register(room, guess, jkf), dets[1]._register(room, guess, kf))
    assert _same(dets[0]._register(corridor, guess, jkf), dets[1]._register(corridor, guess, kf))


def test_loop_closure_reduces_drift():
    """tests/test_pipeline.py's LoopFactor case on the port: absolute-pose
    evidence on the last 6 of 24 heavily drifting scans pulls the estimate
    back, by the JAX package's amount on the same world."""
    jrun = jgenerate(JSynth(n_scans=24, n_points=512, odom_drift_pos_per_m=0.5, odom_drift_yaw_per_m=0.15,
                            seed=9))
    loop = dict(loop_cov=np.diag([1e-4] * 3 + [1e-5] * 3), loop_weight=np.asarray(1.0))
    jb = [b._replace(loop_pose=jax.numpy.asarray(jrun.gt_poses[i]),
                     **{k: jax.numpy.asarray(v) for k, v in loop.items()}) if i >= 18 else b
          for i, b in enumerate(jrun.batches)]
    errs = {}
    for name, batches in (("plain", jrun.batches), ("loop", jb)):
        _, jout = jrunner.run_bag(batches, JConfig(with_map=False))
        _, tout = runner.run_bag([batch_from_numpy(np_tree(b), device="cpu") for b in batches],
                                 PipelineConfig(with_map=False), device="cpu")
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose), rtol=0, atol=NO_MAP_POSE_ATOL)
        errs[name] = np.linalg.norm(tout.pose.numpy()[-1, :2] - jrun.gt_poses[-1, :2])
    assert errs["loop"] < errs["plain"] and errs["loop"] < 0.3, errs


@pytest.fixture(scope="module")
def loiter():
    """tests/test_pipeline.py's loitering world (loops fire early)."""
    run = jgenerate(JSynth(n_scans=60, n_points=1024, odom_drift_pos_per_m=0.08, odom_drift_yaw_per_m=0.04,
                           seed=0))
    return run, [batch_from_numpy(np_tree(b), device="cpu") for b in run.batches]


LOOP_CFG = dict(keyframe_every=5, min_index_gap=15, max_revisit_dist_m=3.0, cooldown_scans=10)


def _loop_parity(loiter, jfn, tfn):
    run, tb = loiter
    _, jout = jfn(run.batches, JConfig(with_map=False), jloop.LoopDetector(jloop.LoopConfig(**LOOP_CFG)))
    _, tout = tfn(tb, PipelineConfig(with_map=False), tloop.LoopDetector(tloop.LoopConfig(**LOOP_CFG)))
    jw, tw = np.asarray(jout.tape.io_loop_weight), tout.tape.io_loop_weight.numpy()
    assert (tw > 0).any(), "no loop factor fired"
    np.testing.assert_array_equal(np.nonzero(tw > 0)[0], np.nonzero(jw > 0)[0])
    np.testing.assert_allclose(tw, jw, rtol=1e-9, atol=0)
    poses = tout.pose.numpy()
    np.testing.assert_allclose(poses, np.asarray(jout.pose), rtol=0, atol=NO_MAP_POSE_ATOL)
    assert np.isfinite(poses).all()
    assert np.linalg.norm(poses[:, :2] - run.gt_poses[:60, :2], axis=1).max() < 1.5


def test_run_chunked_loop_closure_fires_as_in_the_jax_package(loiter):
    """Chunks of 8 with the detector at the boundaries: the factors fire on
    the same scans as the JAX package's run_chunked (16 and 32), and poses
    and loop weights agree to 1e-9 (measured: 1e-14 in pose, the weights
    bit-equal: the detector sees poses that agree to the last bits)."""
    _loop_parity(loiter,
                 lambda b, cfg, det: jrunner.run_chunked(b, cfg, chunk=8, loop_detector=det),
                 lambda b, cfg, det: runner.run_chunked(b, cfg, chunk=8, loop_detector=det, device="cpu"))


def test_run_stream_loop_closure_fires_as_in_the_jax_package(loiter):
    """The per-scan online loop with the detector (keyframes with their
    pose covariance): the same firing scans and poses as the JAX package's
    run_stream."""
    _loop_parity(loiter,
                 lambda b, cfg, det: jrunner.run_stream(b, cfg, loop_detector=det),
                 lambda b, cfg, det: runner.run_stream(b, cfg, loop_detector=det, device="cpu"))


# --- checkpoints -------------------------------------------------------------


@pytest.fixture(scope="module")
def port_state(tbatches):
    state, _ = runner.run_bag(tbatches[:3], PipelineConfig(**SMALL), device="cpu")
    return state


def _assert_states_equal(a, b):
    la, lb = tckpt.state_leaves(a), tckpt.state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_round_trip(tmp_path, port_state):
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, port_state)
    _assert_states_equal(tckpt.load_state(path, tstep.init_state(PipelineConfig(**SMALL), device="cpu")),
                         port_state)
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.load_state(path, tstep.init_state(PipelineConfig(**{**SMALL, "m_tile": 64}), device="cpu"))
    no_map = runner.run_bag(generate(SyntheticConfig(n_scans=2, n_points=256), device="cpu").batches,
                            PipelineConfig(with_map=False), device="cpu")[0]
    tckpt.save_state(path, no_map)
    _assert_states_equal(tckpt.load_state(path, tstep.init_state(PipelineConfig(with_map=False), device="cpu")),
                         no_map)


def _as_jax_state(state, jcfg):
    """The port's state as the JAX package's StepState (numpy leaves in
    JAX's tree order)."""
    treedef = jax.tree_util.tree_structure(jinit_state(jcfg))
    return jax.tree_util.tree_unflatten(treedef, [x.numpy() for x in tckpt.state_leaves(state)])


def test_jax_checkpoint_resumes_in_the_port(tmp_path, port_state):
    jstate = _as_jax_state(port_state, JConfig(**SMALL))
    path = str(tmp_path / "jax_state.npz")
    jckpt.save_state(path, jstate)
    got = tckpt.load_state(path, tstep.init_state(PipelineConfig(**SMALL), device="cpu"))
    _assert_states_equal(got, tstep.state_from_numpy(np_tree(jstate), device="cpu"))
    _assert_states_equal(got, port_state)


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path, port_state):
    jcfg = JConfig(**SMALL)
    path = str(tmp_path / "port_state.npz")
    tckpt.save_state(path, port_state)
    got = jckpt.load_state(path, jinit_state(jcfg))
    want = _as_jax_state(port_state, jcfg)
    for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        x = np.asarray(x)
        assert x.dtype == y.dtype and np.array_equal(x, y)
