"""The port's trajectory and map-event tools and its three device tools
(gcslam_torch/tools) against the JAX package's, on test_forensics'
trajectories and event logs and on tests.test_rosbag._make_bag.

Tolerances, per group:
- evaluate_trajectory_2d, diagnose_trajectory_alignment, trajectory_swaps,
  replay_map_events: none. Both read TUM files and JSON lines and run the
  same float64 numpy, so dicts, printed text, exit codes and the snapshot
  npz arrays are equal. The 2-D plot is SVG in the port (the JAX tool
  draws a PNG with matplotlib): its polylines hold exactly the arrays the
  JAX tool hands Axes.plot.
- dead_reckon, estimate_extrinsics: none on a bag (load_bag rows are
  bit-equal between the packages, tests/test_torch_bag.py, and the
  analysis is the same host float64 numpy) and none on the generator
  (generate is bit-equal to the JAX generator,
  tests/test_torch_slice.py::test_generate_equals_the_jax_generator).
- diagnose_gyro_composition: 1e-9 on every probe number, the same verdict
  (the evidence operators are float64 torch against float64 XLA)."""

import json
import os
import re

import numpy as np
import pytest
import torch

from gcslam_tpu.outputs.tum import write_tum
from tests.test_rosbag import _make_bag
from test_torch_forensics_bag import call_both, capture_plots, run_both, same, svg_polylines, tools
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def trajs(tmp_path_factory):
    """test_forensics' TUM pairs: a planar circle with an SE(2) offset and
    garbage z (planar_*), a 3-D circle with its identity, X/Y-swapped and
    Y-flipped estimates (align_*), an arc with a swapped-frame ground truth
    and a noisy identity one (swap_*), and ground truth stamped 10 s later
    (late_gt)."""
    d = tmp_path_factory.mktemp("trajs")
    p = {}

    def put(name, t, poses):
        p[name] = str(d / f"{name}.tum")
        write_tum(p[name], t, poses)

    t = np.linspace(0, 10, 60)
    gt = np.zeros((60, 6))
    gt[:, 0], gt[:, 1], gt[:, 2] = np.cos(t * 0.5) * 3, np.sin(t * 0.5) * 3, 0.85
    gt[:, 5] = t * 0.5 + np.pi / 2
    est = gt.copy()
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est[:, :2] = gt[:, :2] @ R.T + [5.0, -2.0]
    est[:, 5] += th
    est[:, 2] = np.linspace(0, 4, 60)
    est[:, :2] += np.random.default_rng(0).normal(0, 0.01, (60, 2))
    put("planar_gt", t, gt)
    put("planar_est", t, est)
    put("late_gt", t + 10.0, gt)

    t = np.linspace(0, 20, 120)
    gt = np.zeros((120, 6))
    gt[:, 0], gt[:, 1], gt[:, 2] = np.cos(t * 0.4) * 4, np.sin(t * 0.4) * 4, 0.1 * np.sin(t)
    put("align_gt", t, gt)
    put("align_ok", t, gt + np.random.default_rng(0).normal(0, 0.003, gt.shape))
    est = gt.copy()
    est[:, 0], est[:, 1] = gt[:, 1].copy(), -gt[:, 0].copy()
    put("align_swap", t, est)
    est = gt.copy()
    est[:, 1] = -gt[:, 1]
    put("align_flip", t, est)

    rng = np.random.default_rng(1)
    t = np.arange(60) * 0.1
    est = np.zeros((60, 6))
    est[:, 0], est[:, 1], est[:, 2], est[:, 5] = np.cos(0.2 * t) * 3, np.sin(0.2 * t) * 3, 0.05 * t, 0.2 * t
    put("swap_est", t, est)
    M = np.array([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    gt = est.copy()
    gt[:, :3] = est[:, :3] @ M.T + rng.normal(0, 0.002, (60, 3))
    gt[:, 3:6] = est[:, 3:6] @ M.T
    put("swap_gt", t, gt)
    put("swap_id", t, est + rng.normal(0, 0.002, est.shape))
    return p


FUNCTIONS = [
    ("evaluate_trajectory_2d", "evaluate_trajectory_2d", ["planar_est", "planar_gt"], {}),
    ("evaluate_trajectory_2d", "evaluate_trajectory_2d", ["planar_est", "planar_gt"], dict(rpe_delta_m=0.5)),
    ("evaluate_trajectory_2d", "evaluate_trajectory_2d", ["planar_est", "late_gt"], {}),
    ("diagnose_trajectory_alignment", "diagnose_trajectory_alignment", ["align_ok", "align_gt"], {}),
    ("diagnose_trajectory_alignment", "diagnose_trajectory_alignment", ["align_swap", "align_gt"], {}),
    ("diagnose_trajectory_alignment", "diagnose_trajectory_alignment", ["align_flip", "align_gt"], {}),
    ("diagnose_trajectory_alignment", "diagnose_trajectory_alignment", ["planar_est", "late_gt"], {}),
    ("trajectory_swaps", "rank_swaps", ["swap_est", "swap_gt"], {}),
    ("trajectory_swaps", "rank_swaps", ["swap_est", "swap_id"], {}),
    ("trajectory_swaps", "rank_swaps", ["swap_est", "swap_gt"], dict(include_improper=True)),
]


@pytest.mark.parametrize("tool,fn,keys,kw", FUNCTIONS,
                         ids=[f"{t}-{'-'.join(k)}-{i}" for i, (t, _, k, _) in enumerate(FUNCTIONS)])
def test_function_matches_jax(trajs, tool, fn, keys, kw):
    call_both(tool, fn, *[trajs[k] for k in keys], **kw)


def test_trajectory_verdicts_hold_on_the_port(trajs):
    from gcslam_torch.tools import diagnose_trajectory_alignment as dta, evaluate_trajectory_2d as ev, \
        trajectory_swaps as ts

    info = ev.evaluate_trajectory_2d(trajs["planar_est"], trajs["planar_gt"])
    assert info["n_pairs"] == 60 and info["ate_2d"]["rmse"] < 0.05
    assert dta.diagnose_trajectory_alignment(trajs["align_ok"], trajs["align_gt"])["verdict"] == "CONVENTIONS_OK"
    best = dta.diagnose_trajectory_alignment(trajs["align_swap"], trajs["align_gt"])["best_mappings"][0]
    np.testing.assert_array_equal(best["matrix"], [[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    assert ts.rank_swaps(trajs["swap_est"], trajs["swap_gt"])["best"]["perm"] == "x=-y,y=+x,z=+z"
    assert ts.rank_swaps(trajs["swap_est"], trajs["swap_id"])["identity_is_best"]


CLIS = [
    ("evaluate_trajectory_2d", ["planar_est", "planar_gt", "--json"]),
    ("evaluate_trajectory_2d", ["planar_est", "planar_gt", "--rpe-delta", "0.5", "--max-dt", "0.02"]),
    ("evaluate_trajectory_2d", ["planar_est", "late_gt"]),  # no pairs: exit 1
    ("diagnose_trajectory_alignment", ["align_ok", "align_gt", "--json"]),
    ("diagnose_trajectory_alignment", ["align_swap", "align_gt"]),  # exit 1
    ("diagnose_trajectory_alignment", ["align_flip", "align_gt", "--json"]),  # exit 1
    ("diagnose_trajectory_alignment", ["planar_est", "late_gt", "--max-dt", "0.2"]),  # no pairs: exit 1
    ("trajectory_swaps", ["swap_est", "swap_id", "--top", "3"]),
    ("trajectory_swaps", ["swap_est", "swap_gt", "--improper"]),
]


@pytest.mark.parametrize("tool,argv", CLIS, ids=[f"{c[0]}-{i}" for i, c in enumerate(CLIS)])
def test_cli_matches_jax(trajs, capsys, tool, argv):
    run_both(capsys, tool, [trajs.get(a, a) for a in argv])


def test_evaluate_2d_svg_draws_what_the_jax_tool_plots(trajs, tmp_path, monkeypatch, capsys):
    """The JAX tool's two lines (ground truth, the SE(2)-aligned estimate:
    what it hands Axes.plot) are the SVG's two polylines, value for value;
    the printed report is the same."""
    from gcslam_tpu.tools import evaluate_trajectory_2d as jev
    from gcslam_torch.tools import evaluate_trajectory_2d as ev

    got = capture_plots(monkeypatch)
    args = [trajs["planar_est"], trajs["planar_gt"], "--json"]
    assert jev.main(args + ["--plot", str(tmp_path / "p.png")]) == 0
    ref = capsys.readouterr().out
    assert ev.main(args + ["--plot", str(tmp_path / "p.svg")]) == 0
    assert capsys.readouterr().out == ref
    lines = svg_polylines(tmp_path / "p.svg")
    assert len(lines) == len(got["plot"]) == 2
    for line, (x, y) in zip(lines, got["plot"]):
        np.testing.assert_array_equal(line, np.stack([x, y], 1))
    assert "ground truth" in open(tmp_path / "p.svg").read()


def test_evaluate_2d_runs_without_matplotlib_and_refuses_other_formats(trajs, tmp_path, monkeypatch):
    from gcslam_torch.tools import evaluate_trajectory_2d as ev

    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    args = [trajs["planar_est"], trajs["planar_gt"]]
    assert ev.main(args + ["--plot", str(tmp_path / "p.svg")]) == 0
    assert re.search(r"<polyline", open(tmp_path / "p.svg").read())
    for bad in ("p.png", "p.jpg"):
        with pytest.raises(ValueError, match="svg"):
            ev.main(args + ["--plot", str(tmp_path / bad)])
        assert not (tmp_path / bad).exists()


# --------------------------------------------------------------------------
# replay_map_events
# --------------------------------------------------------------------------

def _write_events(path, corrupt=False, inserts=True):
    """test_forensics' log: 4 scans of 3 inserts each over two tiles; with
    `corrupt`, a duplicate id appended."""
    with open(path, "w") as f:
        gid = 0
        for s in range(4):
            f.write(json.dumps({"scan": s, "t": 100.0 + 0.1 * s, "valid_total": 10.0 * (s + 1)}) + "\n")
            for _ in range(3 if inserts else 0):
                f.write(json.dumps({"scan": s, "event": "insert", "id": gid, "tile_id": 7 + (gid % 2),
                                    "mu_world": [1.0, 2.0, 0.1 * s], "weight": 0.5, "t": 100.0 + 0.1 * s}) + "\n")
                gid += 1
        if corrupt:
            f.write(json.dumps({"scan": 4, "event": "insert", "id": 0, "tile_id": 7, "mu_world": [0, 0, 0],
                                "weight": 1.0, "t": 101.0}) + "\n")


@pytest.mark.parametrize("kind", ["good", "corrupt", "no_inserts"])
def test_replay_map_events_matches_jax(tmp_path, capsys, kind):
    path = str(tmp_path / "map_events.jsonl")
    _write_events(path, corrupt=kind == "corrupt", inserts=kind != "no_inserts")
    for at in (None, 1, 2, 10):
        rep = call_both("replay_map_events", "replay_map_events", path, at_scan=at)
    if kind == "good":
        assert rep["snapshot"]["n_primitives"] == 12 and all(rep["integrity"].values())
    snap = str(tmp_path / "s.npz")
    argv = [path, "--at-scan", "2", "--snapshot", snap, "--json"] if kind != "no_inserts" else [path]
    rc = run_both(capsys, "replay_map_events", argv, arrays=[snap] if kind != "no_inserts" else [])
    assert rc == (1 if kind == "corrupt" else 0)
    run_both(capsys, "replay_map_events", [path, "--at-scan", "0"])


# --------------------------------------------------------------------------
# The device tools: dead_reckon, estimate_extrinsics, diagnose_gyro_composition
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rig_bag(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rig") / "rig.db3")
    _make_bag(path, n_scans=5)
    return path


@pytest.fixture
def python_decode(monkeypatch):
    """Both packages' pure-Python bag decode (bit-equal to each other and
    to the port's native route: tests/test_torch_bag.py)."""
    monkeypatch.setenv("GCSLAM_NO_NATIVE", "1")


def _main_both(capsys, name, argv):
    """Both CLIs on `argv`: the printed report (the JAX main returns None,
    the port's returns the report it prints)."""
    jmod, tmod = tools(name)
    capsys.readouterr()
    jmod.main(list(argv))
    ref = capsys.readouterr().out
    got = tmod.main(list(argv))
    out = capsys.readouterr().out
    assert out == ref
    assert json.loads(out) == got
    return got


@pytest.mark.parametrize("argv", [["--bag", "{bag}", "--points", "256"], ["--scans", "12", "--points", "256"]],
                         ids=["bag", "generator"])
@pytest.mark.parametrize("name", ["dead_reckon", "estimate_extrinsics"])
def test_device_tool_reports_match_jax(rig_bag, capsys, python_decode, name, argv):
    _main_both(capsys, name, [a.format(bag=rig_bag) for a in argv] + ["--cpu"])


def test_analyses_on_loaded_batches_match_jax(rig_bag, python_decode):
    """The public analyses on both packages' load_bag batches (the port's
    on the CPU): the same reports."""
    from gcslam_tpu.frontend import rosbag as jrosbag
    from gcslam_torch.frontend import rosbag

    jb, jgt, _ = jrosbag.load_bag(rig_bag, n_points=256)
    tb, tgt, _ = rosbag.load_bag(rig_bag, n_points=256, device="cpu")
    (jdr, tdr), (jee, tee) = tools("dead_reckon"), tools("estimate_extrinsics")
    gt = np.zeros((len(jb), 6))
    gt[:, 0] = np.linspace(0, 0.4, len(jb))
    same(jdr.analyze(jb, gt), tdr.analyze(tb, gt))
    same(jdr.analyze(jb, jgt), tdr.analyze(tb, tgt))
    same(jee.estimate_imu_gravity(jb), tee.estimate_imu_gravity(tb))
    same(jee.estimate_imu_gravity(jb, low_dyn_quantile=0.6), tee.estimate_imu_gravity(tb, low_dyn_quantile=0.6))
    same(jee.estimate_lidar_ground(jb), tee.estimate_lidar_ground(tb))
    same(jee.estimate_lidar_ground(jb, n_use=0), tee.estimate_lidar_ground(tb, n_use=0))


def _close(a, b, tol=1e-9, path=""):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_diagnose_gyro_composition_matches_jax(capsys):
    jmod, tmod = tools("diagnose_gyro_composition")
    ref, got = jmod.diagnose_gyro_composition(), tmod.diagnose_gyro_composition("cpu")
    _close(ref, got)
    assert got["verdict"] == "OK" and "error" not in got["odom_relative_probe"]
    assert jmod.main(["--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert tmod.main(["--json", "--cpu"]) == 0
    _close(ref, json.loads(capsys.readouterr().out))
    assert tmod.main(["--cpu"]) == 0
    assert "verdict: OK" in capsys.readouterr().out


def test_diagnose_gyro_composition_catches_only_signature_drift(monkeypatch):
    """The port narrows the JAX tool's `except Exception` around the odometry
    probe to TypeError: signature drift still leaves the gyro verdict
    standing, any other error (a device fault) propagates."""
    _, tmod = tools("diagnose_gyro_composition")

    def drift(device=None):
        raise TypeError("odom_quadratic_evidence() got an unexpected keyword argument 'pose_pred'")

    monkeypatch.setattr(tmod, "_probe_odom_relative", drift)
    info = tmod.diagnose_gyro_composition("cpu")
    assert info["verdict"] == "OK" and "unexpected keyword" in info["odom_relative_probe"]["error"]

    def fault(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tmod, "_probe_odom_relative", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tmod.diagnose_gyro_composition("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmod.diagnose_gyro_composition()


@pytest.mark.parametrize("name,argv", [
    ("dead_reckon", ["--bag", "{bag}"]), ("dead_reckon", ["--scans", "3"]),
    ("estimate_extrinsics", ["--bag", "{bag}"]), ("estimate_extrinsics", ["--scans", "3"]),
    ("diagnose_gyro_composition", ["--json"]),
])
def test_device_tools_run_on_the_card_unless_told(rig_bag, monkeypatch, capsys, name, argv):
    """Without a card each device tool raises unless given --cpu; with
    --cpu it runs on the CPU."""
    _, tmod = tools(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(bag=rig_bag) for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmod.main(argv)
    rc = tmod.main(argv + ["--cpu"])
    assert rc == 0 if name == "diagnose_gyro_composition" else isinstance(rc, dict)


def test_host_batches_moves_every_field():
    """models/scan_io.host_batches: numpy arrays equal to the tensors, one
    ScanBatch per scan, and nothing for no scans."""
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.scan_io import host_batches

    batches = generate(SyntheticConfig(n_scans=3, n_points=64), device="cpu").batches
    host = host_batches(batches)
    assert len(host) == 3 and host_batches([]) == []
    for b, h in zip(batches, host):
        for f in b._fields:
            x = np.asarray(getattr(h, f))
            assert x.dtype == getattr(b, f).numpy().dtype and np.array_equal(x, getattr(b, f).numpy()), f


def test_ported_tool_modules_exist():
    """Every tool of the JAX package's tools/ has a port under the same
    name, hlo_census as kernel_census (an eager step has no HLO: the
    census counts the kernels it launches)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def names(pkg):
        files = os.listdir(os.path.join(root, pkg, "tools"))
        return {f[:-3] for f in files if f.endswith(".py") and f != "__init__.py"}

    renamed = {"hlo_census": "kernel_census"}
    assert {renamed.get(n, n) for n in names("gcslam_tpu")} == names("gcslam_torch")


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (its main() is not run)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("a,b,d", [
    (float("nan"), 1.0, float("inf")), (1.0, float("nan"), float("inf")), (float("nan"), float("nan"), 0.0),
    (float("inf"), 1.0, float("inf")), (float("inf"), float("inf"), 0.0), (-float("inf"), float("inf"), float("inf")),
    (0.5, 0.25, 0.25), (2, 2.0, 0.0),
])
def test_chip_smoke_card_cpu_diff_sees_non_finite(chip_smoke, a, b, d):
    """Phase 16's card-against-CPU comparison: a value finite on one side
    only is an infinite gap (so no NaN slips under the bound); the same
    non-finite value on both sides is none."""
    assert chip_smoke.max_diff({"x": [a]}, {"x": [b]}) == d
    assert chip_smoke.max_diff({"x": 0.0, "y": {"z": a}}, {"x": 0.0, "y": {"z": b}}) == d


def test_chip_smoke_records_the_gyro_evidence_unrounded(chip_smoke, capsys):
    """Phase 16 records the evidence operators' unrounded outputs while
    diagnose_gyro_composition runs (three gyro probes, one odometry probe)
    and puts the operators back afterwards."""
    from gcslam_torch.ops import evidence_imu, evidence_odom

    _, tmod = tools("diagnose_gyro_composition")
    before = evidence_imu.imu_gyro_rotation_evidence, evidence_odom.odom_quadratic_evidence
    runs = []
    for _ in range(2):
        with chip_smoke.recorded_evidence([]) as ev:
            assert tmod.main(["--json", "--cpu"]) == 0
        runs.append(ev)
    assert (evidence_imu.imu_gyro_rotation_evidence, evidence_odom.odom_quadratic_evidence) == before
    assert [n for n, _ in runs[0]] == ["imu_gyro_rotation_evidence"] * 3 + ["odom_quadratic_evidence"]
    assert [len(outs) for _, outs in runs[0]] == [3, 3, 3, 2]
    for (_, x), (_, y) in zip(*runs):
        for a, b in zip(x, y):
            assert a.dtype == np.float64 and np.array_equal(a, b)
    capsys.readouterr()
