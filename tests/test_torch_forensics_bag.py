"""The port's bag-preparation and bag-forensics tools (gcslam_torch/tools)
against the JAX package's, tool by tool, on the bags of
tests/test_forensics.py: tests.test_rosbag._make_bag (a resting rig:
LiDAR, IMU, odometry), the same bag with tests.test_camera_bag's camera
topics and a CameraInfo, and test_forensics' turn, plane and moving bags.

Tolerance: none. Both packages read the bags with CDR codecs held
byte-equal (tests/test_torch_bag.py) and run the same float64 numpy, so
the returned dicts must be equal, every CLI must print the same text and
exit with the same code, and every file a tool writes must hold the same
bytes. The one stated difference is the package name where a tool names
itself (check_lidar_mount_angle's hint, usage lines), which the comparison
maps to one token."""

import importlib
import os
import shutil
import sqlite3

import numpy as np
import pytest

from gcslam_tpu.frontend import cdr as jcdr
from tests.test_camera_bag import _add_camera_topics
from tests.test_forensics import _make_moving_bag, _make_plane_bag, _make_turn_bag
from tests.test_rosbag import _make_bag
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

PACKAGES = {"jax": "gcslam_tpu", "torch": "gcslam_torch"}


def tools(name):
    """(JAX tool module, port tool module)."""
    return tuple(importlib.import_module(f"{pkg}.tools.{name}") for pkg in PACKAGES.values())


def same(a, b, path="") -> None:
    """Exact equality of two tool results: dicts, lists, tuples, arrays,
    floats (NaN equal to NaN), strings with the package name mapped."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, str):
        assert a.replace("gcslam_tpu", "PKG") == b.replace("gcslam_torch", "PKG"), (path, a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def call_both(name, fn, *args, **kw):
    """`fn` of both packages' tool on the same arguments: equal results
    (or the same exception type and message); returns the port's."""
    out = {}
    for side, mod in zip(PACKAGES, tools(name)):
        try:
            out[side] = getattr(mod, fn)(*args, **kw)
        except Exception as e:  # noqa: BLE001 (the exception itself is compared)
            out[side] = (type(e).__name__, str(e).replace(PACKAGES[side], "PKG"))
    same(out["jax"], out["torch"])
    return out["torch"]


def run_both(capsys, name, argv, files=(), setup=None, arrays=()):
    """Each package's `main(argv)` in turn on fresh inputs (`setup()`): the
    same return value (or SystemExit code), stdout, stderr, bytes of every
    file in `files` and arrays of every npz in `arrays`; returns the
    port's return value."""
    seen = {}
    for side, mod in zip(PACKAGES, tools(name)):
        for f in (*files, *arrays):
            if os.path.exists(f):
                os.remove(f)
        if setup is not None:
            setup()
        capsys.readouterr()
        try:
            rc = mod.main(list(argv))
        except SystemExit as e:
            rc = ("SystemExit", e.code)
        out = capsys.readouterr()
        pkg = PACKAGES[side]
        seen[side] = dict(rc=rc, out=out.out.replace(pkg, "PKG"), err=out.err.replace(pkg, "PKG"),
                          files={f: open(f, "rb").read() for f in files},
                          arrays={f: {k: v for k, v in np.load(f).items()} for f in arrays})
    same(seen["jax"], seen["torch"])
    return seen["torch"]["rc"]


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """The forensic bags: rig (test_forensics' `bag`), cam (with camera
    topics and a CameraInfo), turn, flip, flat, tilt, move, vary."""
    d = tmp_path_factory.mktemp("forensics_bags")
    p = {k: str(d / f"{k}.db3") for k in ("rig", "cam", "turn", "flip", "flat", "tilt", "move", "vary")}
    _make_bag(p["rig"], n_scans=5)
    shutil.copy(p["rig"], p["cam"])
    _add_camera_topics(p["cam"])
    conn = sqlite3.connect(p["cam"])
    conn.execute("INSERT INTO topics VALUES (6, '/camera/color/camera_info', 'sensor_msgs/msg/CameraInfo', 'cdr', '')")
    ci = jcdr.CameraInfo(header=jcdr.Header(100.05, "cam"), height=96, width=128, distortion_model="plumb_bob",
                         d=np.zeros(5), k=np.array([100.0, 0, 64, 0, 100.0, 48, 0, 0, 1]),
                         r=np.eye(3).reshape(-1), p=np.zeros(12))
    conn.execute("INSERT INTO messages(topic_id, timestamp, data) VALUES (6, ?, ?)",
                 (int(100.05e9), jcdr.serialize_camera_info(ci)))
    conn.commit()
    conn.close()
    _make_turn_bag(p["turn"], gyro_sign=+1.0)
    _make_turn_bag(p["flip"], gyro_sign=-1.0)
    _make_plane_bag(p["flat"], tilt_deg=0.0)
    _make_plane_bag(p["tilt"], tilt_deg=40.0)
    _make_moving_bag(p["move"])
    _make_vary_bag(p["vary"])
    return p


def _make_vary_bag(path: str) -> None:
    """test_forensics' covariance bag: the odometry covariance changes at
    message 3."""
    conn = sqlite3.connect(path)
    conn.executescript(
        """CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,
           serialization_format TEXT, offered_qos_profiles TEXT);
           CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,
           timestamp INTEGER, data BLOB);""")
    conn.execute("INSERT INTO topics VALUES (1,'/odom','nav_msgs/msg/Odometry','cdr','')")
    for i in range(6):
        cov = np.eye(6).reshape(-1) * (1e-4 if i < 3 else 5e-3)
        msg = jcdr.Odometry(header=jcdr.Header(10.0 + 0.1 * i, "odom"), child_frame_id="base",
                            position=np.zeros(3), orientation=np.array([0, 0, 0, 1.0]), pose_cov=cov,
                            twist_linear=np.zeros(3), twist_angular=np.zeros(3), twist_cov=cov)
        conn.execute("INSERT INTO messages(topic_id,timestamp,data) VALUES (1,?,?)",
                     (int((10.0 + 0.1 * i) * 1e9), jcdr.serialize_odometry(msg)))
    conn.commit()
    conn.close()


# --------------------------------------------------------------------------
# The public functions: (tool, function, bag keys as arguments, keywords)
# --------------------------------------------------------------------------

FUNCTIONS = [
    ("validate_conventions", "validate_conventions", ["move"], {}),
    ("validate_conventions", "validate_conventions", ["move"], dict(t_base_imu_rotvec=np.array([np.pi, 0, 0]))),
    ("validate_conventions", "validate_conventions", ["rig"], {}),
    ("bag_info", "bag_info", ["rig"], {}),
    ("bag_info", "bag_info", ["cam"], {}),
    ("first_n_messages_summary", "first_n_messages_summary", ["rig"], dict(n=2)),
    ("first_n_messages_summary", "first_n_messages_summary", ["cam"], dict(n=3)),
    ("first_n_messages_summary", "first_n_messages_summary", ["rig"], dict(topics=["/odom", "/none"])),
    ("inspect_bag_deep", "inspect_bag_deep", ["rig"], {}),
    ("inspect_bag_deep", "inspect_bag_deep", ["cam"], {}),
    ("inspect_bag_deep", "inspect_bag_deep", ["flat"], {}),
    ("inspect_odom_covariance", "inspect_odom_covariance", ["rig"], {}),
    ("inspect_odom_covariance", "inspect_odom_covariance", ["vary"], {}),
    ("inspect_odom_covariance", "inspect_odom_covariance", ["flat"], {}),
    ("inspect_odom_source", "inspect_odom_source", ["rig"], {}),
    ("inspect_odom_source", "inspect_odom_source", ["move"], {}),
    ("inspect_odom_source", "inspect_odom_source", ["flat"], {}),
    ("inspect_camera_frames", "inspect_camera_frames", ["cam"], {}),
    ("inspect_camera_frames", "inspect_camera_frames", ["rig"], {}),
    ("compare_accel_odom", "compare_accel_odom", ["rig"], {}),
    ("compare_accel_odom", "compare_accel_odom", ["move"], dict(max_samples=50)),
    ("compare_accel_odom", "compare_accel_odom", ["flat"], {}),
    ("compare_imu_sources", "compare_imu_sources", ["rig"], {}),
    ("compare_imu_sources", "compare_imu_sources", ["turn"], dict(topics=["/imu/data", "/missing"])),
    ("compare_imu_sources", "compare_imu_sources", ["flat"], {}),
    ("check_lidar_mount_angle", "check_lidar_mount_angle", ["flat"], dict(skip=0, n_scans=5)),
    ("check_lidar_mount_angle", "check_lidar_mount_angle", ["tilt"], dict(skip=0, n_scans=5)),
    ("check_lidar_mount_angle", "check_lidar_mount_angle", ["rig"], dict(skip=0)),
    ("check_lidar_mount_angle", "check_lidar_mount_angle", ["turn"], {}),
    ("check_turn_invariant", "check_turn_invariant", ["rig"], {}),
    ("check_turn_invariant", "check_turn_invariant", ["turn"], {}),
    ("check_turn_invariant", "check_turn_invariant", ["flip"], {}),
    ("check_turn_invariant", "check_turn_invariant", ["flat"], {}),
    ("diagnose_frames", "diagnose_frames", ["rig"], {}),
    ("diagnose_frames", "diagnose_frames", ["move"], {}),
    ("diagnose_frames", "diagnose_frames", ["turn"], {}),
]


@pytest.mark.parametrize("tool,fn,keys,kw", FUNCTIONS,
                         ids=[f"{t}-{'-'.join(k)}-{i}" for i, (t, _, k, _) in enumerate(FUNCTIONS)])
def test_function_matches_jax(bags, tool, fn, keys, kw):
    call_both(tool, fn, *[bags[k] for k in keys], **kw)


def test_forensic_verdicts_hold_on_the_port(bags):
    """test_forensics' verdicts, read off the port's results (the parity
    cases above hold them equal to the JAX package's)."""
    from gcslam_torch.tools import (check_lidar_mount_angle, check_turn_invariant, compare_imu_sources,
                                    inspect_odom_covariance, inspect_odom_source, validate_conventions)

    assert inspect_odom_covariance.inspect_odom_covariance(bags["vary"])["first_differing_index"] == 3
    assert inspect_odom_source.inspect_odom_source(bags["rig"])["verdict"].startswith("POSE_ONLY")
    assert check_turn_invariant.check_turn_invariant(bags["flip"])["verdict"] == "GYRO_Z_FLIPPED"
    assert check_turn_invariant.check_turn_invariant(bags["turn"])["verdict"] == "OK"
    assert check_lidar_mount_angle.check_lidar_mount_angle(bags["tilt"], skip=0, n_scans=5)["verdict"] == "ANGLED"
    assert compare_imu_sources.compare_imu_sources(bags["rig"])["recommended"] == "/imu/data"
    rep = validate_conventions.validate_conventions(bags["move"], t_base_imu_rotvec=np.array([np.pi, 0, 0]))
    assert rep["gyro_vs_odom_yawrate"]["sign_flipped"] and not rep["gravity_alignment"]["aligned"]


# --------------------------------------------------------------------------
# The CLIs: (tool, argv with {bag keys} and {tmp}/ paths, written files,
# written npz) — test_forensics' calls, their other flags, and its
# failing inputs with their exit codes
# --------------------------------------------------------------------------

CLIS = [
    ("validate_conventions", ["{move}", "--json"], [], None),
    ("validate_conventions", ["{move}", "--t-base-imu", "3.14159265,0,0", "--max-msgs", "40"], [], None),
    ("bag_info", ["{rig}"], [], None),
    ("bag_info", ["{cam}"], [], None),
    ("bag_info", [], [], None),  # usage, exit 2
    ("first_n_messages_summary", ["{rig}", "--json", "{tmp}/s.json", "--n", "2"], ["s.json"], None),
    ("first_n_messages_summary", ["{cam}", "--topics", "/odom", "/camera/color/compressed"], [], None),
    ("inspect_bag_deep", ["{rig}", "--json", "{tmp}/deep.json"], ["deep.json"], None),
    ("inspect_bag_deep", ["{flat}"], [], None),  # no IMU / odometry topic: exit 1
    ("inspect_odom_covariance", ["{rig}"], [], None),
    ("inspect_odom_covariance", ["{vary}", "--json", "--dump-csv", "{tmp}/cov.csv"], ["cov.csv"], None),
    ("inspect_odom_covariance", ["{flat}"], [], None),
    ("inspect_odom_source", ["{rig}"], [], None),
    ("inspect_odom_source", ["{move}", "--json", "--max", "30"], [], None),
    ("inspect_odom_source", ["{flat}"], [], None),
    ("inspect_camera_frames", ["{cam}"], [], None),
    ("inspect_camera_frames", ["{cam}", "--json"], [], None),
    ("inspect_camera_frames", ["{rig}"], [], None),
    ("dump_raw_imu_odom", ["{rig}", "--out-dir", "{tmp}", "--max-imu", "50", "--max-odom", "10"],
     ["imu_raw_first_50.csv", "odom_raw_first_10.csv"], None),
    ("dump_raw_imu_odom", ["{move}", "--out-dir", "{tmp}"], ["imu_raw_first_300.csv", "odom_raw_first_300.csv"],
     None),
    ("dump_raw_imu_odom", ["{flat}", "--out-dir", "{tmp}"], [], None),
    ("compare_accel_odom", ["{rig}"], [], None),
    ("compare_accel_odom", ["{move}", "--config", "{tmp}/imu_cfg.yaml", "--csv", "{tmp}/acc.csv", "--json"],
     ["acc.csv"], "imu_cfg"),
    ("compare_accel_odom", ["{flat}"], [], None),
    ("compare_imu_sources", ["{rig}"], [], None),
    ("compare_imu_sources", ["{turn}", "--json", "--topics", "/imu/data", "/missing"], [], None),
    ("compare_imu_sources", ["{flat}"], [], None),
    ("check_extrinsics", ["{tmp}/cfg.yaml", "--bag", "{rig}"], [], "extrinsics"),
    ("check_extrinsics", ["{tmp}/bad.yaml", "--bag", "{rig}"], [], "extrinsics"),  # tilted IMU: exit 2
    ("check_extrinsics", ["{tmp}/cfg.yaml", "--bag", "{flat}", "--json"], [], "extrinsics"),
    ("check_extrinsics", ["{tmp}/nofrontend.yaml"], [], "extrinsics"),  # exit 1
    ("check_lidar_mount_angle", ["{flat}", "--skip", "0"], [], None),
    ("check_lidar_mount_angle", ["{tilt}", "--skip", "0", "--n-scans", "5", "--json"], [], None),
    ("check_lidar_mount_angle", ["{turn}"], [], None),
    ("check_turn_invariant", ["{rig}"], [], None),
    ("check_turn_invariant", ["{turn}"], [], None),
    ("check_turn_invariant", ["{flip}", "--json"], [], None),  # exit 1
    ("check_turn_invariant", ["{flip}", "--yaw-thresh", "0.3"], [], None),
    ("diagnose_frames", ["{rig}", "--json"], [], None),
    ("diagnose_frames", ["{move}", "--max-scans", "3"], [], None),
    ("kimera_calibration_to_gc", ["{tmp}/extrinsics.yaml"], [], "kimera"),
    ("kimera_calibration_to_gc", ["{tmp}/extrinsics.yaml", "--apply", "--config", "{tmp}/gc.yaml",
                                  "--imu-rotation", "-1.6", "0.0", "0.1"], ["gc.yaml"], "kimera"),
    ("kimera_calibration_to_gc", ["{tmp}/camera_chain.yaml", "--apply", "--config", "{tmp}/gc.yaml"], ["gc.yaml"],
     "kimera"),
    ("kimera_calibration_to_gc", ["{tmp}/no_gyro.yaml"], [], "kimera"),  # exit 1
    ("kimera_calibration_to_gc", ["{tmp}/extrinsics.yaml", "--apply", "--config", "{tmp}/plain.yaml"],
     ["plain.yaml"], "kimera"),  # no T_base_* line: exit 1
    ("compute_time_alignment", ["{rig}", "--reference", "/lidar/points", "--topics", "/imu/data", "/odom",
                                "/lidar/points", "--out", "{tmp}/prof.yaml"], ["prof.yaml"], None),
    ("compute_time_alignment", ["{cam}", "--reference", "/lidar/points", "--topics", "/imu/data", "/odom",
                                "/camera/color/compressed", "--duration", "0.25", "--out", "{tmp}/prof.json"],
     ["prof.json"], None),
    ("compute_time_alignment", ["{turn}", "--reference", "/imu/data", "--topics", "/odom", "/missing"], [], None),
    ("apply_imu_extrinsic", ["{tmp}/imu_raw_first_50.csv", "--rotvec", "3.14159265,0,0", "--out",
                             "{tmp}/imu_base.csv"], ["imu_base.csv"], "imu_csv"),
    ("apply_imu_extrinsic", ["{tmp}/imu_raw_first_50.csv", "--rotvec", "0.1,-0.2,1.5"], ["imu_raw_first_50_base.csv"],
     "imu_csv"),
]

KIMERA_EXT = (
    "transforms:\n"
    "  - name: T_baselink_lidar\n"
    "    T: [[0, -1, 0, 0.1], [1, 0, 0, -0.2], [0, 0, 1, 0.3], [0, 0, 0, 1]]\n"
    "  - name: T_cameralink_gyro\n"
    "    T: [[1, 0, 0, 0.01], [0, 1, 0, 0.02], [0, 0, 1, 0.03], [0, 0, 0, 1]]\n"
)
CAMERA_CHAIN = (
    "  - name: T_baselink_cameralink\n"
    "    T: [[1, 0, 0, 0.2], [0, 1, 0, 0.0], [0, 0, 1, 0.4], [0, 0, 0, 1]]\n"
    "  - name: T_cameralink_color\n"
    "    T: [[1, 0, 0, 0.0], [0, 1, 0, 0.015], [0, 0, 1, 0.0], [0, 0, 0, 1]]\n"
    "  - name: T_color_coloroptical\n"
    "    T: [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]]\n"
)


def _setup(kind, tmp, bags):
    """The input files a CLI case reads (written afresh before each
    package's run: some tools rewrite them in place)."""
    def write(name, text):
        (tmp / name).write_text(text)

    if kind == "kimera":
        write("extrinsics.yaml", KIMERA_EXT)
        write("camera_chain.yaml", KIMERA_EXT + CAMERA_CHAIN)
        write("no_gyro.yaml", KIMERA_EXT.split("  - name: T_cameralink_gyro")[0])
        write("gc.yaml", "with_map: true\nfrontend:\n  T_base_lidar: [0, 0, 0, 0, 0, 0]\n"
                         "  T_base_imu: [0, 0, 0, 0, 0, 0]\n    T_base_camera:   [1, 2, 3, 0, 0, 0]\n")
        write("plain.yaml", "with_map: true\n")
    elif kind == "extrinsics":
        write("cfg.yaml", "with_map: false\nfrontend:\n  T_base_lidar: [0,0,0, 0,0,0]\n  T_base_imu: [0,0,0, 0,0,0]\n")
        write("bad.yaml", "with_map: false\nfrontend:\n  T_base_imu: [0,0,0, 1.5707963, 0, 0]\n")
        write("nofrontend.yaml", "with_map: false\n")
    elif kind == "imu_cfg":
        write("imu_cfg.yaml", "frontend:\n  imu_topic: /imu\n  odom_topic: /odom\n"
                              "  T_base_imu: [0.1, 0, 0, 0.02, -0.01, 0.3]\n  imu_accel_scale: 1.0\n")
    elif kind == "imu_csv":
        from gcslam_tpu.tools.dump_raw_imu_odom import dump_raw_imu_odom

        dump_raw_imu_odom(bags["move"], str(tmp), max_imu=50, max_odom=10)


def _fill(argv, tmp, bags):
    return [a.replace("{tmp}", str(tmp)).format(**bags) if "{" in a else a for a in argv]


@pytest.mark.parametrize("tool,argv,files,setup", CLIS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CLIS)])
def test_cli_matches_jax(bags, tmp_path, capsys, tool, argv, files, setup):
    run_both(capsys, tool, _fill(argv, tmp_path, bags), files=[str(tmp_path / f) for f in files],
             setup=(lambda: _setup(setup, tmp_path, bags)) if setup else None)


def test_cli_exit_codes(bags, tmp_path, capsys):
    """The exit codes of test_forensics' failing inputs (held equal to the
    JAX package's above), read off the port."""
    from gcslam_torch.tools import check_extrinsics, check_turn_invariant, inspect_bag_deep

    _setup("extrinsics", tmp_path, bags)
    assert check_extrinsics.main([str(tmp_path / "cfg.yaml"), "--bag", bags["rig"]]) == 0
    assert check_extrinsics.main([str(tmp_path / "bad.yaml"), "--bag", bags["rig"]]) == 2
    assert check_turn_invariant.main([bags["flip"], "--json"]) == 1
    assert inspect_bag_deep.main([bags["flat"]]) == 1


def test_time_alignment_profile_reads_back_in_both_packages(bags, tmp_path):
    """The port's profile, as YAML and as JSON, loads to the same stream
    alignments in both packages' frontend/time_alignment.load_alignment,
    with finite offsets for the IMU and odometry streams."""
    from gcslam_tpu.frontend import time_alignment as jta
    from gcslam_torch.frontend import time_alignment as ta
    from gcslam_torch.tools import compute_time_alignment

    for suffix in ("yaml", "json"):
        out = str(tmp_path / f"p.{suffix}")
        compute_time_alignment.main([bags["rig"], "--reference", "/lidar/points", "--topics", "/imu/data", "/odom",
                                     "--out", out])
        got, ref = ta.load_alignment(out), jta.load_alignment(out)
        assert set(got) == set(ref) == {"/imu/data", "/odom"}
        for k in got:
            assert (got[k].offset_sec, got[k].drift, got[k].t0_sec) == (ref[k].offset_sec, ref[k].drift, ref[k].t0_sec)
            assert np.isfinite(got[k].offset_sec)
    err = call_both("compute_time_alignment", "compute_profile", bags["rig"], "/absent", ["/odom"])
    assert err[0] == "ValueError" and "no messages" in err[1]


def test_kimera_conversion_matches_jax(tmp_path):
    _setup("kimera", tmp_path, {})
    ext = str(tmp_path / "extrinsics.yaml")
    out = call_both("kimera_calibration_to_gc", "convert", ext)
    np.testing.assert_allclose(out["T_base_lidar"][3:], [0, 0, np.pi / 2], atol=1e-5)
    call_both("kimera_calibration_to_gc", "convert", ext, imu_rotation=[-1.6, 0.0, 0.1])
    call_both("kimera_calibration_to_gc", "convert", str(tmp_path / "camera_chain.yaml"))
    for R in (np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, -1.0, 1.0]), np.eye(3)):  # the near-pi branch, identity
        call_both("kimera_calibration_to_gc", "_rotmat_to_rotvec", R)


def test_apply_imu_extrinsic_function_matches_jax(bags, tmp_path):
    _setup("imu_csv", tmp_path, bags)
    csv_in = str(tmp_path / "imu_raw_first_50.csv")
    rep = call_both("apply_imu_extrinsic", "apply_imu_extrinsic", csv_in, np.array([np.pi, 0, 0]),
                    str(tmp_path / "out.csv"))
    assert rep["n_rows"] == 50 and rep["mean_accel_base"][2] < -9.5
    (tmp_path / "bad.csv").write_text("stamp_sec,wx,wy\n1,2,3\n")
    err = call_both("apply_imu_extrinsic", "apply_imu_extrinsic", str(tmp_path / "bad.csv"), np.zeros(3),
                    str(tmp_path / "o.csv"))
    assert err[0] == "ValueError" and "columns" in err[1]


def test_dump_raw_imu_odom_function_matches_jax(bags, tmp_path):
    """The returned paths and topics, with the CSVs' bytes compared by the
    CLI cases above."""
    for key in ("rig", "cam", "flat"):
        call_both("dump_raw_imu_odom", "dump_raw_imu_odom", bags[key], str(tmp_path / key), max_imu=20, max_odom=5)


# --------------------------------------------------------------------------
# plot_wz_odom: the same series, drawn as SVG
# --------------------------------------------------------------------------

def svg_polylines(path):
    """Each <polyline>'s points as an (n, 2) array of the floats written."""
    import re

    text = open(path).read()
    return [np.array([[float(v) for v in p.split(",")] for p in pts.split()])
            for pts in re.findall(r'<polyline points="([^"]*)"', text)]


def capture_plots(monkeypatch):
    """What matplotlib's Axes.plot and Axes.scatter receive, as lists of
    the positional arrays."""
    from matplotlib.axes import Axes

    got = {"plot": [], "scatter": []}
    for name in got:
        orig = getattr(Axes, name)

        def rec(self, *args, _orig=orig, _name=name, **kw):
            got[_name].append([np.asarray(a) for a in args if not isinstance(a, str)])
            return _orig(self, *args, **kw)

        monkeypatch.setattr(Axes, name, rec)
    return got


@pytest.mark.parametrize("source", ["csv", "bag"])
def test_plot_wz_svg_draws_what_the_jax_tool_plots(bags, tmp_path, monkeypatch, source):
    """The JAX tool's wz(t) line (what it hands Axes.plot) is the SVG's
    polyline, value for value; its two scatters are the SVG's circles, one
    each; the printed summary is the same."""
    from gcslam_tpu.tools import plot_wz_odom as jplot
    from gcslam_torch.tools import dump_raw_imu_odom, plot_wz_odom

    path = bags["turn"]
    if source == "csv":
        path = dump_raw_imu_odom.dump_raw_imu_odom(bags["turn"], str(tmp_path), max_odom=60)["odom_csv"]
    for a, b in zip(jplot.load_wz(path), plot_wz_odom.load_wz(path)):
        np.testing.assert_array_equal(a, b)
    got = capture_plots(monkeypatch)
    assert jplot.main([path, "--out", str(tmp_path / "wz.png")]) == 0
    (x, y), = got["plot"]
    assert plot_wz_odom.main([path, "--out", str(tmp_path / "wz.svg")]) == 0
    (line,) = svg_polylines(tmp_path / "wz.svg")
    np.testing.assert_array_equal(line, np.stack([x, y], 1))
    text = open(tmp_path / "wz.svg").read()
    assert text.count("<circle") == sum(len(s[0]) for s in got["scatter"]) == 2 * len(x)


def test_plot_wz_runs_without_matplotlib_and_refuses_other_formats(bags, tmp_path, monkeypatch, capsys):
    from gcslam_torch.tools import plot_wz_odom

    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert plot_wz_odom.main([bags["move"], "--out", str(tmp_path / "wz.svg")]) == 0
    assert "wrote" in capsys.readouterr().out
    for bad in ("wz.png", "wz.pdf", "wz"):
        with pytest.raises(ValueError, match="svg"):
            plot_wz_odom.main([bags["move"], "--out", str(tmp_path / bad)])
        assert not (tmp_path / bad).exists()
    assert plot_wz_odom.main([bags["move"], "--out", str(tmp_path / "w.SVG")]) == 0


@pytest.fixture(scope="module")
def axes_tums(tmp_path_factory):
    """test_forensics' trajectories for diagnose_trajectory_axes: the moving
    bag's odometry path (ok.tum), and the same motion moved into z
    (bad.tum)."""
    from gcslam_tpu.outputs.tum import write_tum

    d = tmp_path_factory.mktemp("axes")
    t = 50.0 + 0.1 * np.arange(80)
    ok, bad = np.zeros((80, 6)), np.zeros((80, 6))
    ok[:, 0] = bad[:, 2] = 0.2 * np.arange(80)
    ok[:, 1] = bad[:, 1] = 0.5 * np.sin(0.3 * np.arange(80))
    write_tum(str(d / "ok.tum"), t, ok)
    write_tum(str(d / "bad.tum"), t, bad)
    return {"ok": str(d / "ok.tum"), "bad": str(d / "bad.tum")}


@pytest.mark.parametrize("tum", ["ok", "bad", None])
def test_diagnose_trajectory_axes_matches_jax(bags, axes_tums, capsys, tum):
    args = [bags["move"]] + ([axes_tums[tum]] if tum else [])
    rep = call_both("diagnose_trajectory_axes", "diagnose_trajectory_axes", *args)
    if tum:
        assert rep["verdict"].startswith("OK" if tum == "ok" else "AXIS MISMATCH")
    call_both("diagnose_trajectory_axes", "diagnose_trajectory_axes", *args, max_odom=20)
    run_both(capsys, "diagnose_trajectory_axes", args)
    run_both(capsys, "diagnose_trajectory_axes", args + ["--json", "--max-odom", "40"])

