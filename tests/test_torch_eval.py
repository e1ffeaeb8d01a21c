"""The port's evaluation path against the JAX package's: config_from_file
on both config files, the trajectory metrics (compute_rpe) and ground-truth
tools, the runtime manifest, the auditor, and `eval.run.main(["--cpu",
...])` end to end on a small bag (8 scans of 1024 returns, 80 x 60
frames, camera on; see EVAL_WORLD) at the SMALL budgets of
tests/test_torch_slice.py with a 0.3 m voxel (EVAL_CONFIG): the same
artifacts, ATE and RPE within the slice's pose tolerance, the same audit
checks, all passing. The JAX
package's run is its jitted per-scan step (one compilation), shared by the
tests through a module fixture."""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gcslam_tpu.eval import ate_rpe as jate, audit as jaudit, gt_tools as jgt, run as jrun
from gcslam_tpu.frontend import rosbag as jrosbag
from gcslam_tpu.models import manifest as jmanifest
from gcslam_tpu.models.config import PipelineConfig as JConfig, config_from_file as jconfig_from_file
from gcslam_torch.eval import ate_rpe, audit, gt_tools, run
from gcslam_torch.frontend import rosbag
from gcslam_torch.frontend.bag_synth import write_synth_bag
from gcslam_torch.frontend.synthetic import SyntheticConfig
from gcslam_torch.models import manifest
from gcslam_torch.models.config import PipelineConfig, config_from_file, read_config_mapping
from test_torch_bag import CAM_SIZE, KIMERA, SYNTH, jax_native, kimera_bag_configs  # noqa: F401 (fixture)
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_config import EXCLUDED
from test_torch_slice import POSE_ATOL, SMALL

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = [str(ROOT / "configs" / "gc_kimera.yaml"), str(ROOT / "configs" / "gc_default.yaml")]
# the JAX package's manifest keys with no counterpart in the port: its
# three XLA backend selectors
JAX_ONLY_MANIFEST = {f"config.{k}" for k in EXCLUDED}
# the port's manifest keys with no counterpart in the JAX package: the
# frontend route GCSLAM_NO_NATIVE picks (the JAX package records none)
PORT_ONLY_MANIFEST = {"frontend_route"}
# The eval runs read the first EVAL_SCANS scans of an 80-scan world: in a
# 6-scan world the rig's start ramp (a quarter of the run) is so short
# that neither package's map takes a primitive in 6 scans.
EVAL_WORLD = dict(SYNTH, n_scans=80)
EVAL_SCANS = 8
# The SMALL budgets with the Kimera config's 0.3 m surfel voxel. At SMALL's
# 0.5 m the young map of this world (11-35 primitives) has a measurement at
# the insert decision on scan 4 (camera on) or 6 (camera off): one package
# inserts a primitive the other does not, and poses part by ~4e-3 m. That
# is the young-map knife edge of ROADMAP queue 3, not a port fault; at
# 0.3 m both packages' maps take the same primitives on every scan.
EVAL_CONFIG = dict(SMALL, surfel_voxel_size_m=0.3, with_camera=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_native):
    """eval.run --cpu from both packages on the shared small bag: {"jax":
    (out dir, metrics), "torch": ...}."""
    d = tmp_path_factory.mktemp("eval")
    _, bag_cfg = kimera_bag_configs()
    db, gt = str(d / "bag.db3"), str(d / "bag.tum")
    write_synth_bag(db, SyntheticConfig(**EVAL_WORLD), bag_cfg, gt_path=gt, cam_size=CAM_SIZE)
    fe = dict(read_config_mapping(KIMERA)["frontend"])
    fe["camera_intrinsics"] = list(bag_cfg.camera_intrinsics)
    fe["time_alignment_path"] = str(ROOT / "configs" / "time_alignment" / "kimera_10_14_acl_jackal_005.yaml")
    cfg_path = d / "small.json"
    cfg_path.write_text(json.dumps({**EVAL_CONFIG, "frontend": fe}))
    out = {}
    for name, main in (("jax", jrun.main), ("torch", run.main)):
        out_dir = str(d / name)
        out[name] = out_dir, main(["--cpu", "--bag", db, "--gt", gt, "--config", str(cfg_path), "--points", "512",
                                   "--frontend-set", f"max_scans={EVAL_SCANS}", "--out", out_dir])
    return out


def test_eval_run_writes_the_same_artifacts(runs):
    names = {k: sorted(os.listdir(v[0])) for k, v in runs.items()}
    assert names["torch"] == names["jax"]
    assert {"runtime_manifest.json", "trajectory.tum", "ground_truth.tum", "diagnostics.npz", "splat_export.npz",
            "metrics.json", "metrics.csv", "dashboard.html", "map_events.jsonl", "audit.json"} <= set(names["torch"])


def test_eval_run_ate_and_rpe_match(runs):
    """ATE and RPE from both packages within the slice's pose tolerance;
    the trajectories and ground truth too."""
    (jdir, jm), (tdir, tm) = runs["jax"], runs["torch"]
    assert tm["n_scans"] == jm["n_scans"] == EVAL_SCANS
    assert tm["n_splats"] == jm["n_splats"] > 0
    for key in ("translation", "rotation_deg"):
        for stat in ("rmse", "mean", "median", "max"):
            assert abs(tm["ate"][key][stat] - jm["ate"][key][stat]) <= POSE_ATOL * (1 if key == "translation"
                                                                                   else np.degrees(1))
    for scale, r in jm["rpe"].items():
        assert tm["rpe"][scale]["n_pairs"] == r["n_pairs"]
    for name in ("trajectory.tum", "ground_truth.tum"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(tdir, name)), np.loadtxt(os.path.join(jdir, name)),
                                   rtol=0, atol=POSE_ATOL)
    assert tm["ate"]["translation"]["rmse"] < 0.1


def test_eval_run_audit_has_the_same_checks_all_passing(runs):
    a = {k: json.load(open(os.path.join(v[0], "audit.json"))) for k, v in runs.items()}
    assert sorted(a["torch"]) == sorted(a["jax"])
    assert a["torch"]["all_pass"] and a["jax"]["all_pass"]
    assert all(v["pass"] for v in a["torch"].values() if isinstance(v, dict))


def test_eval_run_metrics_leave_out_the_xla_counters(runs):
    """metrics.json names the device and the port's timings; its
    device_runtime carries the transfer ledger, equal to the JAX run's
    (both replay the bag through run_bag: one commit of the same bytes,
    the poses and stamps read back), beside the device inventory; the JAX
    package's XLA-only counters (jit-cache sizes, x64 status, compile wall
    time) are not there, not even as placeholders."""
    (jdir, jm), (tdir, tm) = runs["jax"], runs["torch"]
    on_disk = json.load(open(os.path.join(tdir, "metrics.json")))
    assert on_disk["ate"] == tm["ate"] and on_disk["device"] == "cpu"
    assert {"load_s", "wall_s", "device_runtime", "n_splats"} <= set(on_disk)
    drt, jdrt = on_disk["device_runtime"], jm["device_runtime"]
    ledger = ("h2d_bytes", "h2d_calls", "d2h_bytes", "host_syncs")
    assert {k: drt[k] for k in ledger} == {k: jdrt[k] for k in ledger}
    assert drt["h2d_calls"] == 1 and drt["host_syncs"] == 2 and drt["native_builds"] >= 0
    assert {"platform", "n_devices", "device_kinds"} <= set(drt)
    assert not {"run_scan_compiles", "step_compiles", "jit_cache_entries", "x64_enabled",
                "compilation_cache_entries"} & set(drt)
    assert "wall_s_including_compile" not in on_disk
    rows = open(os.path.join(tdir, "metrics.csv")).read().splitlines()
    assert rows[0] == "key,value" and any(r.startswith("ate.translation.rmse,") for r in rows)


def test_dashboard_has_the_reference_panels(runs):
    """The same panel titles as the JAX package's dashboard, drawn as
    inline SVG (no plotting package)."""
    import re

    pages = {k: open(os.path.join(v[0], "dashboard.html")).read() for k, v in runs.items()}
    titles = {k: re.findall(r"<h3>(.*?)</h3>", p) for k, p in pages.items()}
    assert titles["torch"] == titles["jax"] and len(titles["torch"]) >= 15
    assert pages["torch"].count("<svg") >= len(titles["torch"]) and "<img" not in pages["torch"]


def test_manifest_matches_jax(runs):
    (jdir, _), (tdir, _) = runs["jax"], runs["torch"]
    jm = json.load(open(os.path.join(jdir, "runtime_manifest.json")))
    tm = json.load(open(os.path.join(tdir, "runtime_manifest.json")))
    assert set(tm) - PORT_ONLY_MANIFEST == set(jm) - JAX_ONLY_MANIFEST
    for k in set(tm) - {"backends", "device_runtime"} - PORT_ONLY_MANIFEST:
        assert tm[k] == jm[k], k
    assert set(tm["backends"]) == set(jm["backends"])
    assert tm["device_runtime"]["platform"] == "cpu"
    assert tm["frontend_route"] == "native"  # the JAX run's route too (jax_native)
    got = manifest.runtime_manifest(PipelineConfig(**SMALL))
    ref = jmanifest.runtime_manifest(JConfig(**SMALL))
    assert {k: v for k, v in got.items() if k not in PORT_ONLY_MANIFEST | {"backends"}} == {
        k: v for k, v in ref.items() if k not in JAX_ONLY_MANIFEST | {"backends"}}


@pytest.mark.parametrize("breakage", ["nan_pose", "stamps_back", "unknown_trigger", "negative_mass", "no_trajectory"])
def test_audit_flags_what_the_jax_audit_flags(runs, tmp_path, breakage):
    """A broken copy of the port's artifacts: both auditors give the same
    pass/fail on every check."""
    d = tmp_path / "out"
    shutil.copytree(runs["torch"][0], d)
    traj = np.loadtxt(d / "trajectory.tum")
    if breakage == "nan_pose":
        traj[2, 1] = np.nan
    elif breakage == "stamps_back":
        traj[3, 0] = traj[1, 0]
    if breakage in ("nan_pose", "stamps_back"):
        np.savetxt(d / "trajectory.tum", traj)
    elif breakage == "unknown_trigger":
        diag = dict(np.load(d / "diagnostics.npz"))
        diag["cert_triggers"] = diag["cert_triggers"] | (1 << 62)
        np.savez(d / "diagnostics.npz", **diag)
    elif breakage == "negative_mass":
        sp = dict(np.load(d / "splat_export.npz"))
        sp["masses"][0] = -1.0
        np.savez(d / "splat_export.npz", **sp)
    else:
        os.remove(d / "trajectory.tum")
    got, ref = audit.audit_run(str(d)), jaudit.audit_run(str(d))
    assert {k: v["pass"] for k, v in got.items() if isinstance(v, dict)} == {
        k: v["pass"] for k, v in ref.items() if isinstance(v, dict)}
    assert not got["all_pass"] and got["all_pass"] == ref["all_pass"]


def test_eval_run_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Everything the JAX package's CLI takes now runs: --live-view (the
    file backend, one line per scan) and --precision f32 (the process
    re-executes itself with GCSLAM_BELIEF_DTYPE set, so it runs as a
    child here). What stays refused is a run without a card unless --cpu."""
    live = tmp_path / "live"
    run.main(["--cpu", "--no-map", "--live-view", str(live), "--scans", "2", "--points", "256",
              "--out", str(tmp_path / "a")])
    assert [json.loads(line)["scan"] for line in open(live / "live.jsonl")] == [0, 1]
    env = {k: v for k, v in os.environ.items() if k != "GCSLAM_BELIEF_DTYPE"}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    out = subprocess.run([sys.executable, "-m", "gcslam_torch.eval.run", "--cpu", "--precision", "f32", "--no-map",
                          "--scans", "2", "--points", "256", "--out", str(tmp_path / "b")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.load(open(tmp_path / "b" / "runtime_manifest.json"))["belief_dtype"] == "float32"
    assert np.isfinite(np.loadtxt(tmp_path / "b" / "trajectory.tum")).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run.main(["--scans", "2", "--out", str(tmp_path / "c")])


@pytest.mark.parametrize("path", CONFIGS, ids=["gc_kimera", "gc_default"])
def test_config_from_file_matches_jax(path):
    got, ref = config_from_file(path), jconfig_from_file(path)
    assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(ref).items() if k not in EXCLUDED}
    over = dict(with_camera=False, odom_pose_mode="relative")
    assert dataclasses.asdict(config_from_file(path, **over)) == {
        k: v for k, v in dataclasses.asdict(jconfig_from_file(path, **over)).items() if k not in EXCLUDED}


def test_config_from_file_refuses_like_jax(tmp_path):
    for bad in ({"with_map": True, "n_surfl": 3}, {"k_hyp": 3}, [1, 2]):
        p = tmp_path / "bad.json"
        p.write_text(json.dumps(bad))
        with pytest.raises(ValueError) as ej:
            jconfig_from_file(str(p))
        with pytest.raises(ValueError) as et:
            config_from_file(str(p))
        assert str(et.value) == str(ej.value)


def test_bag_config_from_file_matches_jax():
    got, ref = rosbag.bag_config_from_file(KIMERA), jrosbag.bag_config_from_file(KIMERA)
    g, r = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert g == r and len(g["alignment"]) == 4
    assert rosbag.bag_config_from_file(CONFIGS[1]) is None is jrosbag.bag_config_from_file(CONFIGS[1])


def _trajectories(n, seed):
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 1, n)
    gt = np.stack([8 * np.cos(s * 3), 5 * np.sin(s * 4), 0.3 * s, 0.02 * np.sin(9 * s), 0.03 * s, 2.5 * s], -1)
    est = gt + np.concatenate([rng.normal(0, 0.05, (n, 3)), rng.normal(0, 0.01, (n, 3))], -1).cumsum(0) / 5
    return est, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_rpe_and_ate_match_jax(seed):
    est, gt = _trajectories(120, seed)
    for deltas in ((1.0, 5.0, 10.0), (0.5, 2.0, 100.0)):
        got, ref = ate_rpe.compute_rpe(est, gt, deltas), jate.compute_rpe(est, gt, deltas)
        assert got == ref and all(v["n_pairs"] for k, v in got.items() if k != "100m")
    for align in ("initial", "umeyama", "none"):
        assert ate_rpe.compute_ate(est, gt, align) == jate.compute_ate(est, gt, align)
    R = ate_rpe._rotvec_to_R(est[:, 3:6])
    for a, b in zip(ate_rpe._compose(R, est[:, :3], R[::-1], gt[:, :3]),
                    jate._compose(R, est[:, :3], R[::-1], gt[:, :3])):
        np.testing.assert_array_equal(a, b)


def test_gt_tools_match_jax(tmp_path):
    est, gt = _trajectories(50, 3)
    st = np.linspace(100.0, 105.0, 50)
    q = st[5:45] + 0.013
    assert gt_tools.check_time_overlap(q, st) == jgt.check_time_overlap(q, st)
    assert gt_tools.check_time_overlap(st + 4.0, st) == jgt.check_time_overlap(st + 4.0, st)
    for a, b in zip(gt_tools.interpolate_gt(st, gt, np.concatenate([q, [99.0, 200.0]])),
                    jgt.interpolate_gt(st, gt, np.concatenate([q, [99.0, 200.0]]))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(6)
    quat = rng.normal(size=(20, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rows = np.concatenate([(1.6e18 + 1e8 * np.arange(20))[:, None], rng.normal(size=(20, 3)), quat], 1)
    csv = tmp_path / "gt.csv"
    np.savetxt(csv, rows, delimiter=",", header="t,x,y,z,qw,qx,qy,qz", fmt="%.9f")
    assert gt_tools.csv_gt_to_tum(str(csv), str(tmp_path / "t.tum")) == jgt.csv_gt_to_tum(str(csv),
                                                                                          str(tmp_path / "j.tum"))
    assert (tmp_path / "t.tum").read_text() == (tmp_path / "j.tum").read_text()
