"""The port's offline bag frontend against the JAX package's: the CDR codec,
the native decoder (csrc/bag_decode.cpp) against the JAX package's parse,
the synthetic Kimera-schema bag writer, the MCAP container, time alignment,
the image helpers, the native camera-feature route and load_bag.

Inputs are made from seeds with numpy. The shared bag is
write_synth_bag(SyntheticConfig(n_scans=6, n_points=1024, seed=0)) with
configs/gc_kimera.yaml's `frontend:` section (point budget 512) and 80 x 60
camera frames (the intrinsics scaled to them). The JAX package's native
route runs on a library built here from native/gcslam_native.cpp with
native/Makefile's command, into a temporary directory (its own
`make -C native` writes in place, and parallel test workers would race on
the file)."""

import dataclasses
import pathlib
import sqlite3
import subprocess

import numpy as np
import pytest
import torch

from gcslam_tpu import constants as JC
from gcslam_tpu.frontend import (
    bag_synth as jbag_synth, camera as jcamera, cdr as jcdr, images as jimages, mcap as jmcap,
    native as jnative, rosbag as jrosbag, time_alignment as jta,
)
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth
from gcslam_torch import constants as C
from gcslam_torch.frontend import (
    bag_synth, camera, cdr, images, mcap, native, rosbag, time_alignment,
)
from gcslam_torch.frontend.synthetic import SyntheticConfig
from tests.test_camera_bag import INTR, _add_camera_topics
from tests.test_rosbag import _make_bag
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KIMERA = str(ROOT / "configs" / "gc_kimera.yaml")
ALIGN = str(ROOT / "configs" / "time_alignment" / "kimera_10_14_acl_jackal_005.yaml")
SYNTH = dict(n_scans=6, n_points=1024, seed=0)
CAM_SIZE = (80, 60)
NON_CAMERA = [f for f in rosbag.ScanBatch._fields if not f.startswith("cam_")]
CAMERA = [f for f in rosbag.ScanBatch._fields if f.startswith("cam_")]
# Camera rows of the native route: both packages lift the same C++ corners
# in float64 with the float32 LiDAR operands promoted; the reductions (the
# Route A/B weighted sums, the 3x3 eigen-solve of the Route-B plane fit)
# may sum in another order, and the near-rank-deficient plane fit of
# Route B (SKILL.md) can grow an ulp to ~1e-10 of the row's scale.
CAM_RTOL, CAM_ATOL = 1e-9, 1e-12


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native decode route on a library built from
    native/gcslam_native.cpp with native/Makefile's command."""
    so = tmp_path_factory.mktemp("jax_native") / "libgcslam_native.so"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared",
                    "-o", str(so), str(ROOT / "native" / "gcslam_native.cpp"), "-ljpeg", "-ldl", "-pthread"],
                   check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB_PATH", str(so))
    mp.setattr(jnative, "_lib", None)
    mp.delenv("GCSLAM_NO_NATIVE", raising=False)
    assert jnative.available() and jnative.stream_available()
    yield jnative
    mp.undo()


def kimera_bag_configs(n_points=512):
    """(JAX BagConfig, port BagConfig) from configs/gc_kimera.yaml, the
    camera intrinsics scaled from 640 x 480 to the shared bag's frames."""
    out = []
    for mod in (jrosbag, rosbag):
        cfg = mod.bag_config_from_file(KIMERA)
        intr = tuple(x * CAM_SIZE[0] / 640 for x in cfg.camera_intrinsics)
        out.append(dataclasses.replace(cfg, n_points=n_points, camera_intrinsics=intr))
    return tuple(out)


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """The shared bag written by each package: {"jax": (db3, tum), "torch": ...}."""
    d = tmp_path_factory.mktemp("bags")
    jcfg, tcfg = kimera_bag_configs()
    out = {}
    for name, write, synth, cfg in (("jax", jbag_synth.write_synth_bag, JSynth, jcfg),
                                    ("torch", bag_synth.write_synth_bag, SyntheticConfig, tcfg)):
        db, gt = str(d / f"{name}.db3"), str(d / f"{name}.tum")
        write(db, synth(**SYNTH), cfg, gt_path=gt, cam_size=CAM_SIZE)
        out[name] = (db, gt)
    return out


@pytest.fixture(scope="module")
def loaded(bags, jax_native):
    """load_bag from both packages on the JAX-written bag (native routes)."""
    jcfg, tcfg = kimera_bag_configs()
    jb, _, _ = jrosbag.load_bag(bags["jax"][0], config=jcfg)
    tb, _, _ = rosbag.load_bag(bags["jax"][0], config=tcfg, device="cpu")
    return jb, tb


def field(batches, name, torch_side):
    return np.stack([getattr(b, name).numpy() if torch_side else np.asarray(getattr(b, name)) for b in batches])


# --------------------------------------------------------------------------
# CDR codec
# --------------------------------------------------------------------------

def _messages(pkg):
    """One seeded message of every type, built with `pkg`'s structs."""
    rng = np.random.default_rng(5)
    n = 40
    raw = rng.integers(0, 256, (n, 22), dtype=np.uint8).tobytes()
    fields = [pkg.PointField(nm, off, dt, 1) for nm, off, dt in
              (("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7), ("ring", 16, 4), ("time", 18, 7))]
    h = pkg.Header(1665772901.387538, "frame")
    return {
        "pointcloud2": (pkg.serialize_pointcloud2, pkg.parse_pointcloud2, pkg.PointCloud2(
            h, 1, n, fields, False, 22, 22 * n, raw, True)),
        "imu": (pkg.serialize_imu, pkg.parse_imu, pkg.Imu(
            h, rng.normal(size=4), rng.normal(size=3), rng.normal(size=3), rng.normal(size=9), rng.normal(size=9))),
        "odometry": (pkg.serialize_odometry, pkg.parse_odometry, pkg.Odometry(
            h, "base_link", rng.normal(size=3), rng.normal(size=4), rng.normal(size=36), rng.normal(size=3),
            rng.normal(size=3), rng.normal(size=36))),
        "image": (pkg.serialize_image, pkg.parse_image, pkg.Image(
            h, 6, 5, "16UC1", False, 10, rng.integers(0, 256, 60, dtype=np.uint8).tobytes())),
        "compressed_image": (pkg.serialize_compressed_image, pkg.parse_compressed_image, pkg.CompressedImage(
            h, "rgb8; jpeg compressed bgr8", rng.integers(0, 256, 77, dtype=np.uint8).tobytes())),
        "camera_info": (pkg.serialize_camera_info, pkg.parse_camera_info, pkg.CameraInfo(
            h, 480, 640, "plumb_bob", rng.normal(size=5), rng.normal(size=9), rng.normal(size=9),
            rng.normal(size=12), 1, 2)),
    }


def _same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", list(_messages(jcdr)))
def test_cdr_serialize_and_parse_are_byte_equal(kind):
    """Every message type: the port serializes the same bytes as the JAX
    package, and parses them to the same fields (exact)."""
    jser, jparse, jmsg = _messages(jcdr)[kind]
    tser, tparse, tmsg = _messages(cdr)[kind]
    buf = tser(tmsg)
    assert buf == jser(jmsg)
    _same(jparse(buf), tparse(buf))
    assert cdr.header_stamp(buf) == jcdr.header_stamp(buf)


def test_pointcloud2_to_arrays_matches_jax():
    msg = jcdr.parse_pointcloud2(jbag_cloud())
    for a, b in zip(jcdr.pointcloud2_to_arrays(msg), cdr.pointcloud2_to_arrays(cdr.parse_pointcloud2(jbag_cloud()))):
        np.testing.assert_array_equal(a, b)


def jbag_cloud(n=300, seed=3):
    """A seeded VLP-16-layout PointCloud2 payload with a non-finite point."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((n, 22), dtype=np.uint8)
    pts = rng.normal(0, 5, (n, 3)).astype("<f4")
    pts[3] = np.nan
    raw[:, 0:12] = pts.view(np.uint8).reshape(n, 12)
    raw[:, 16:18] = rng.integers(0, 16, (n, 1)).astype("<u2").view(np.uint8).reshape(n, 2)
    raw[:, 18:22] = np.linspace(0, 0.1, n).astype("<f4").view(np.uint8).reshape(n, 4)
    return jcdr.serialize_pointcloud2(jcdr.PointCloud2(
        jcdr.Header(42.25, "lidar"), 1, n, jbag_synth._FIELDS, False, 22, 22 * n, raw.tobytes(), True))


# --------------------------------------------------------------------------
# the native decoder
# --------------------------------------------------------------------------

def test_native_pointcloud2_matches_jax(jax_native):
    """The port's decoder against the JAX package's native parse (equal)
    and its Python codec (the same float32 points; stamps within 1 ns)."""
    buf = jbag_cloud()
    got = native.parse_pointcloud2(buf, 512, C.NONFINITE_SENTINEL)
    ref = jax_native.parse_pointcloud2(buf, 512, JC.NONFINITE_SENTINEL)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    xyz, t, ring, tag = jcdr.pointcloud2_to_arrays(jcdr.parse_pointcloud2(buf))
    np.testing.assert_array_equal(got[0], xyz.astype(np.float32))
    np.testing.assert_allclose(got[1], t, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[2], ring)
    with pytest.raises(ValueError):
        native.parse_pointcloud2(b"\x00\x00" + buf[2:], 512, C.NONFINITE_SENTINEL)  # big-endian flag


def test_native_imu_and_odometry_batches_match_jax(jax_native):
    rng = np.random.default_rng(8)
    imus = [jcdr.serialize_imu(jcdr.Imu(jcdr.Header(10.0 + i * 0.005, "imu"), np.array([0, 0, 0, 1.0]),
                                        rng.normal(0, 1, 3), rng.normal(0, 1, 3) + [0, 0, 9.81]))
            for i in range(16)]
    got = native.parse_imu_batch(imus)
    for a, b in zip(jax_native.parse_imu_batch(imus), got):
        np.testing.assert_array_equal(a, b)
    ref = [jcdr.parse_imu(b) for b in imus]
    np.testing.assert_array_equal(got[0], [m.header.stamp_sec for m in ref])
    np.testing.assert_array_equal(got[1], np.stack([m.angular_velocity for m in ref]))
    np.testing.assert_array_equal(got[2], np.stack([m.linear_acceleration for m in ref]))

    odos = [jcdr.serialize_odometry(jcdr.Odometry(
        jcdr.Header(20.0 + i * 0.05, "odom"), "base", rng.normal(0, 1, 3), rng.normal(0, 1, 4),
        rng.normal(0, 1, 36), rng.normal(0, 1, 3), rng.normal(0, 1, 3), rng.normal(0, 1, 36))) for i in range(5)]
    got = native.parse_odometry_batch(odos)
    for a, b in zip(jax_native.parse_odometry_batch(odos), got):
        np.testing.assert_array_equal(a, b)
    ref = [jcdr.parse_odometry(b) for b in odos]
    np.testing.assert_array_equal(got[1], np.stack([m.position for m in ref]))
    np.testing.assert_array_equal(got[3], np.stack([m.pose_cov for m in ref]))
    np.testing.assert_array_equal(got[4], np.stack([np.concatenate([m.twist_linear, m.twist_angular])
                                                    for m in ref]))
    assert all(x.shape[0] == 0 for x in native.parse_imu_batch([]) + native.parse_odometry_batch([]))


def test_native_stream_matches_the_bulk_parse(tmp_path, jax_native):
    """The async streamer yields the scans the per-message parse gives, in
    order, equal to the JAX package's streamer; closing it early joins the
    worker."""
    path = str(tmp_path / "s.db3")
    _make_bag(path, n_scans=5)
    raw = rosbag.read_bag_messages(path)
    topic = next(n for n, t in raw.pop("__types__").items() if "PointCloud2" in t)
    bulk = [native.parse_pointcloud2(buf, 1 << 16, C.NONFINITE_SENTINEL) for _, buf in raw[topic]]
    streamed = list(native.stream_pointclouds(path, topic, 1 << 16, C.NONFINITE_SENTINEL))
    ref = list(jax_native.stream_pointclouds(path, topic, 1 << 16, JC.NONFINITE_SENTINEL))
    assert len(streamed) == len(bulk) == len(ref) == 5
    for s, b, r in zip(streamed, bulk, ref):
        for x, y, z in zip(s[:5], b, r[:5]):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        assert s[5] == r[5] > 0
    gen = native.stream_pointclouds(path, topic, 1 << 16, C.NONFINITE_SENTINEL)
    assert next(gen)[0].shape[1] == 3
    gen.close()


def test_native_stream_refuses_an_unparseable_row(tmp_path):
    """A LiDAR row the decoder cannot parse raises at the end of the stream
    (the decoder's worker skips it; the port does not pass that on)."""
    path = str(tmp_path / "bad.db3")
    _make_bag(path, n_scans=3)
    conn = sqlite3.connect(path)
    tid, data = conn.execute("SELECT m.id, m.data FROM messages m JOIN topics t ON m.topic_id = t.id "
                             "WHERE t.type LIKE '%PointCloud2' ORDER BY m.timestamp LIMIT 1").fetchone()
    conn.execute("UPDATE messages SET data = ? WHERE id = ?", (b"\x00\x00" + bytes(data)[2:], tid))
    conn.commit()
    conn.close()
    with pytest.raises(ValueError, match="could not be parsed"):
        list(native.stream_pointclouds(path, "/lidar/points", 1 << 16, C.NONFINITE_SENTINEL))


def test_native_build_failure_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the bag decoder failed") as e:
        native.build()
    assert "broken.cpp" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_build_is_named_by_source_and_target(tmp_path, monkeypatch):
    """A build goes to csrc/build/ under a hashed name, once; another source
    is another library."""
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    first = native.build()
    assert first.exists() and first.parent == tmp_path / "build" and first.name.startswith("libbag_decode_")
    stamp = first.stat().st_mtime_ns
    assert native.build() == first and first.stat().st_mtime_ns == stamp
    src = tmp_path / "bag_decode.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// changed\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != first


# --------------------------------------------------------------------------
# containers, alignment, images
# --------------------------------------------------------------------------

def test_write_synth_bag_rows_are_byte_equal(bags):
    """Both writers: the same topics and the same message rows, byte for
    byte (the JPEG rows given the same PIL), and the same ground truth."""
    rows = {}
    for name, (db, gt) in bags.items():
        conn = sqlite3.connect(db)
        rows[name] = (list(conn.execute("SELECT * FROM topics ORDER BY id")),
                      list(conn.execute("SELECT topic_id, timestamp, data FROM messages ORDER BY id")))
        conn.close()
        rows[name] += (open(gt).read(),)
    assert rows["torch"] == rows["jax"]
    assert len(rows["jax"][1]) > SYNTH["n_scans"] * 10


def test_mcap_reader_and_load_bag_match(tmp_path, bags, jax_native):
    """The bag's rows through the port's McapWriter: both packages' readers
    return the same messages, and load_bag reads the .mcap (per-message
    native parse) to the .db3's batches."""
    db, _ = bags["jax"]
    raw = jrosbag.read_bag_messages(db)
    types = raw.pop("__types__")
    path = str(tmp_path / "bag.mcap")
    w = mcap.McapWriter(path)
    for topic, typ in types.items():
        w.add_channel(topic, typ)
    for t, topic, data in sorted((t, topic, d) for topic, msgs in raw.items() for t, d in msgs):
        w.write_message(topic, t, data)
    w.close()
    got, ref = mcap.read_mcap_messages(path), jmcap.read_mcap_messages(path)
    assert got == ref and got["__types__"] == types
    _, tcfg = kimera_bag_configs()
    cfg = dataclasses.replace(tcfg, with_camera=False)
    a, _, _ = rosbag.load_bag(db, config=cfg, device="cpu")
    b, _, _ = rosbag.load_bag(path, config=cfg, device="cpu")
    for f in rosbag.ScanBatch._fields:
        np.testing.assert_array_equal(field(a, f, True), field(b, f, True), err_msg=f)


def test_time_alignment_profile_matches_jax():
    got, ref = time_alignment.load_alignment(ALIGN), jta.load_alignment(ALIGN)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == {k: dataclasses.asdict(v) for k, v in ref.items()}
    t = 1665772901.387538 + np.linspace(0, 300, 7)
    for k in ref:
        np.testing.assert_array_equal(got[k].apply(t), ref[k].apply(t))
    assert time_alignment.estimate_offset(t, t + 0.25) == jta.estimate_offset(t, t + 0.25)


def test_image_helpers_match_jax():
    rng = np.random.default_rng(2)
    h, w = 12, 10
    mm = rng.integers(0, 6000, (h, w)).astype("<u2")
    f32 = rng.uniform(0, 4, (h, w)).astype("<f4")
    f32[0, 0] = np.nan
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for enc, data, step in (("16UC1", mm.tobytes(), 2 * w), ("32FC1", f32.tobytes(), 4 * w)):
        msg = jcdr.Image(jcdr.Header(0.0, ""), h, w, enc, False, step, data)
        np.testing.assert_array_equal(images.depth_to_meters(msg, 0.001), jimages.depth_to_meters(msg, 0.001))
    for enc in ("rgb8", "bgr8"):
        msg = jcdr.Image(jcdr.Header(0.0, ""), h, w, enc, False, 3 * w, rgb.tobytes())
        np.testing.assert_array_equal(images.image_to_array(msg), jimages.image_to_array(msg))
    np.testing.assert_array_equal(images.to_gray01(rgb), jimages.to_gray01(rgb))
    rs, ds = np.sort(rng.uniform(0, 2, 20)), np.sort(rng.uniform(0, 2, 17))
    assert images.pair_rgbd(rs, ds, 0.05) == jimages.pair_rgbd(rs, ds, 0.05)


def test_jpeg_decode_matches_jax(jax_native):
    """PIL (the port) and libjpeg (the JAX package's native route) decode
    the bag's JPEG frames; both channel orders."""
    from tests.test_camera_bag import _checkerboard, _jpeg_bytes

    data = _jpeg_bytes(_checkerboard(32, 48))
    for fmt in ("jpeg", "rgb8; jpeg compressed bgr8"):
        msg = jcdr.CompressedImage(jcdr.Header(0.0, ""), fmt, data)
        got, ref = images.decode_compressed(msg), jimages.decode_compressed(msg)
        assert got.shape == (32, 48, 3)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2  # tests/test_camera_bag.py's bound


# --------------------------------------------------------------------------
# camera features and load_bag
# --------------------------------------------------------------------------

def test_extract_camera_features_native_matches_jax(jax_native):
    """The C++ corner/depth/plane stage, then the lift in each package:
    the same valid rows, uv exact, the rest within CAM_RTOL."""
    H, W = 120, 160
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    gray = (((xx // 12 + yy // 12) % 2) * 0.7 + 0.1) + rng.normal(0, 0.01, (H, W))
    depth = (3.0 - 0.004 * xx).astype(np.float32)
    rgb = np.stack([gray, 0.5 * gray, 1.0 - gray], -1).astype(np.float32)
    lidar = np.stack([rng.uniform(-2, 2, 2000), rng.uniform(-1.5, 1.5, 2000), rng.uniform(2.0, 3.5, 2000)], -1)
    w = rng.uniform(0.2, 1.0, 2000)
    intr = camera.PinholeIntrinsics(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2)
    jintr = jcamera.PinholeIntrinsics(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2)
    ref = jcamera.extract_camera_features_native(gray, depth, rgb, jintr, lidar, w, n_feat=128)
    got = camera.extract_camera_features_native(gray, depth, rgb, intr, lidar, w, n_feat=128, device="cpu")
    assert np.array_equal(np.asarray(ref.valid), got.valid.numpy()) and int(got.valid.sum()) > 30
    np.testing.assert_array_equal(np.asarray(ref.uv), got.uv.numpy())
    for f in ("depth", "Lambdas", "thetas", "etas", "weights", "colors"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=CAM_RTOL,
                                   atol=CAM_ATOL * np.abs(np.asarray(getattr(ref, f))).max(), err_msg=f)


def test_load_bag_lidar_imu_odometry_and_time_are_bit_equal(loaded):
    jb, tb = loaded
    assert len(jb) == len(tb) == SYNTH["n_scans"]
    for f in NON_CAMERA:
        a, b = field(jb, f, False), field(tb, f, True)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_load_bag_camera_rows_match(loaded):
    """The native camera route on both sides (CAM_RTOL, with its reason at
    the top of this file); the same valid rows, and real features."""
    jb, tb = loaded
    valid = field(jb, "cam_valid", False)
    np.testing.assert_array_equal(valid, field(tb, "cam_valid", True))
    assert valid.sum(1).min() > 20
    for f in CAMERA:
        a, b = field(jb, f, False).astype(np.float64), field(tb, f, True).astype(np.float64)
        np.testing.assert_allclose(b, a, rtol=CAM_RTOL, atol=CAM_ATOL * np.abs(a).max(), err_msg=f)


def test_load_bag_python_decode_matches_jax(bags, monkeypatch, jax_native):
    """native=False (the pure-Python CDR codec) against the JAX package's
    GCSLAM_NO_NATIVE=1 route and the port's native route: every field of a
    camera-off replay bit-equal."""
    jcfg, tcfg = kimera_bag_configs()
    jcfg, tcfg = dataclasses.replace(jcfg, with_camera=False), dataclasses.replace(tcfg, with_camera=False)
    db = bags["torch"][0]
    got, _, _ = rosbag.load_bag(db, config=tcfg, device="cpu", native=False)
    nat, _, _ = rosbag.load_bag(db, config=tcfg, device="cpu")
    monkeypatch.setenv("GCSLAM_NO_NATIVE", "1")
    ref, _, _ = jrosbag.load_bag(db, config=jcfg)
    for f in rosbag.ScanBatch._fields:
        np.testing.assert_array_equal(field(got, f, True), field(ref, f, False), err_msg=f)
        np.testing.assert_array_equal(field(got, f, True), field(nat, f, True), err_msg=f)


def test_load_bag_python_camera_route_runs(bags):
    """native=False with the camera: the pure (Harris) camera route, on the
    JPEG frames; features found on every scan."""
    _, tcfg = kimera_bag_configs()
    got, _, _ = rosbag.load_bag(bags["torch"][0], config=dataclasses.replace(tcfg, max_scans=2), device="cpu",
                                native=False)
    assert len(got) == 2 and min(int(b.cam_valid.sum()) for b in got) > 0


def test_load_bag_fails_fast_like_jax(tmp_path):
    """tests/test_camera_bag.py's fail-fast cases on the port: a camera bag
    config without RGB-D streams, and RGB-D streams without intrinsics."""
    bag = str(tmp_path / "nocam.db3")
    _make_bag(bag, n_scans=2)
    with pytest.raises(ValueError, match="no usable RGB-D"):
        rosbag.load_bag(bag, config=rosbag.BagConfig(n_points=256, with_camera=True, camera_intrinsics=INTR),
                        device="cpu")
    bag2 = str(tmp_path / "noK.db3")
    _make_bag(bag2, n_scans=2)
    _add_camera_topics(bag2, n_frames=2)
    with pytest.raises(ValueError, match="camera_intrinsics"):
        rosbag.load_bag(bag2, config=rosbag.BagConfig(n_points=256, with_camera=True), device="cpu")
    with pytest.raises(ValueError, match="unknown BagConfig keys"):
        rosbag.bag_config_from_dict({"lidar_topc": "/x"})


def test_load_bag_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    bag = str(tmp_path / "b.db3")
    _make_bag(bag, n_scans=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rosbag.load_bag(bag, n_points=256)
    batches, _, _ = rosbag.load_bag(bag, n_points=256, device="cpu")
    assert len(batches) == 2 and batches[0].points.device.type == "cpu"


def test_point_budget_resample_and_topic_summary_match_jax(bags):
    rng = np.random.default_rng(4)
    n = 3000
    args = (rng.normal(size=(n, 3)), rng.uniform(size=n), rng.uniform(size=n), rng.integers(0, 16, n).astype(np.int32),
            np.zeros(n, np.int32))
    for cap in (512, 4096):
        for a, b in zip(jrosbag.point_budget_resample(*args, cap), rosbag.point_budget_resample(*args, cap)):
            np.testing.assert_array_equal(a, b)
    assert rosbag.bag_topic_summary(bags["jax"][0]) == jrosbag.bag_topic_summary(bags["jax"][0])
