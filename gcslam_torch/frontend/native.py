"""ctypes bindings for the port's bag decoder (csrc/bag_decode.cpp, the JAX
package's native/gcslam_native.cpp without its libjpeg decoder):
PointCloud2 parse, batch IMU and odometry parse, the async rosbag2 sqlite
LiDAR streamer and the visual-feature stage (corners, robust depth, plane
fit). JPEG frames decode with PIL (frontend/images.py).

The library is built at first use with g++ and native/Makefile's compile
flags into gcslam_torch/csrc/build/. Its name carries a hash of the source,
the flags and the CPU target g++ resolves for `-march=native`, so a changed
source or another CPU builds anew; the build writes a temporary file and
renames it into place, so concurrent processes never load a half-written
library. A failed build raises with g++'s log. Nothing here falls back to
the Python codec: callers that want it ask for it (`native=False` to
rosbag.load_bag and synthetic.generate), or set GCSLAM_NO_NATIVE=1, the JAX
package's switch, which `resolve_native` reads for callers that pass
`native=None`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

from gcslam_torch.utils.profiling import COUNTERS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "bag_decode.cpp"
BUILD = CSRC / "build"
# native/Makefile's CXXFLAGS, and its libraries less -ljpeg
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread"]
LDLIBS = ["-ldl", "-pthread"]

NO_NATIVE_ENV = "GCSLAM_NO_NATIVE"

_lib = None


def native_by_default() -> bool:
    """The route of a caller that names none: the native library unless
    GCSLAM_NO_NATIVE=1."""
    return os.environ.get(NO_NATIVE_ENV) != "1"


def resolve_native(native, what: str) -> bool:
    """The route `what` takes: `native` when the caller gives True or False,
    else the switch. A route picked by GCSLAM_NO_NATIVE=1 is said on stderr."""
    if native is not None:
        return bool(native)
    if native_by_default():
        return True
    print(f"gcslam_torch: {NO_NATIVE_ENV}=1: {what} takes the Python route", file=sys.stderr)
    return False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _march_native() -> str:
    """The CPU target g++ resolves for -march=native (part of the library's
    name: a library built for one CPU is not loaded on another)."""
    proc = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{_cxx()} -march=native -Q --help=target failed ({proc.returncode}):\n{proc.stderr}")
    return "".join(line for line in proc.stdout.splitlines(True) if re.match(r"\s*-m(arch|tune)=", line))


def library_path() -> Path:
    key = SOURCE.read_bytes() + " ".join([_cxx()] + CXXFLAGS + LDLIBS).encode() + _march_native().encode()
    return BUILD / f"libbag_decode_{hashlib.sha256(key).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the bag decoder unless its library exists; returns its path."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        cmd = [_cxx(), *CXXFLAGS, "-shared", "-o", tmp, str(SOURCE), *LDLIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the bag decoder failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        COUNTERS.count_build()
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded bag decoder (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    signatures = {
        "gcslam_parse_pointcloud2": (ctypes.c_int32, [u8p, ctypes.c_int64, ctypes.c_int64, f32p, f64p, i32p, i32p,
                                                      f64p, ctypes.c_double]),
        "gcslam_parse_imu_batch": (ctypes.c_int32, [u8p, i64p, i64p, ctypes.c_int64, f64p, f64p, f64p]),
        "gcslam_parse_odometry_batch": (ctypes.c_int32, [u8p, i64p, i64p, ctypes.c_int64, f64p, f64p, f64p, f64p,
                                                         f64p, f64p]),
        "gcslam_visual_features": (ctypes.c_int32, [u8p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                                    ctypes.c_float, ctypes.c_int32, f32p, f32p, f32p, f32p, f32p,
                                                    f32p]),
        "gcslam_stream_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
                                                 ctypes.c_int32]),
        "gcslam_stream_next": (ctypes.c_int32, [ctypes.c_void_p, f32p, f64p, i32p, i32p, f64p, f64p]),
        "gcslam_stream_skipped": (ctypes.c_int32, [ctypes.c_void_p]),
        "gcslam_stream_close": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def parse_pointcloud2(buf: bytes, max_points: int, sentinel: float):
    """-> (xyz (n, 3) f32, t (n,) f64, ring (n,) i32, tag (n,) i32, stamp);
    raises on a payload the decoder cannot parse (not little-endian CDR)."""
    lib = library()
    b = np.frombuffer(buf, dtype=np.uint8)
    xyz = np.empty((max_points, 3), np.float32)  # the first n rows are written
    t = np.empty(max_points, np.float64)
    ring = np.empty(max_points, np.int32)
    tag = np.empty(max_points, np.int32)
    stamp = ctypes.c_double(0.0)
    n = lib.gcslam_parse_pointcloud2(
        _ptr(b, ctypes.c_uint8), len(buf), max_points,
        _ptr(xyz, ctypes.c_float), _ptr(t, ctypes.c_double),
        _ptr(ring, ctypes.c_int32), _ptr(tag, ctypes.c_int32),
        ctypes.byref(stamp), float(sentinel),
    )
    if n < 0:
        raise ValueError("PointCloud2 payload is not a little-endian CDR message the native decoder parses")
    return xyz[:n], t[:n], ring[:n], tag[:n], float(stamp.value)


def _pack_blob(payloads):
    lengths = np.asarray([len(p) for p in payloads], np.int64)
    offsets = np.zeros(len(payloads), np.int64)
    if len(payloads) > 1:
        np.cumsum(lengths[:-1], out=offsets[1:])
    blob = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    return blob, offsets, lengths


def parse_imu_batch(payloads):
    """-> (stamps (n,), gyro (n, 3), accel (n, 3))."""
    n = len(payloads)
    stamps, gyro, accel = np.zeros(n), np.zeros((n, 3)), np.zeros((n, 3))
    if n:
        blob, offsets, lengths = _pack_blob(payloads)
        library().gcslam_parse_imu_batch(
            _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), _ptr(lengths, ctypes.c_int64), n,
            _ptr(stamps, ctypes.c_double), _ptr(gyro, ctypes.c_double), _ptr(accel, ctypes.c_double),
        )
    return stamps, gyro, accel


def parse_odometry_batch(payloads):
    """-> (stamps, pos (n, 3), quat (n, 4), pose_cov (n, 36), twist (n, 6),
    twist_cov (n, 36))."""
    n = len(payloads)
    stamps, pos, quat = np.zeros(n), np.zeros((n, 3)), np.zeros((n, 4))
    pcov, twist, tcov = np.zeros((n, 36)), np.zeros((n, 6)), np.zeros((n, 36))
    if n:
        blob, offsets, lengths = _pack_blob(payloads)
        library().gcslam_parse_odometry_batch(
            _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), _ptr(lengths, ctypes.c_int64), n,
            _ptr(stamps, ctypes.c_double), _ptr(pos, ctypes.c_double), _ptr(quat, ctypes.c_double),
            _ptr(pcov, ctypes.c_double), _ptr(twist, ctypes.c_double), _ptr(tcov, ctypes.c_double),
        )
    return stamps, pos, quat, pcov, twist, tcov


def visual_features(gray_u8, depth_f32, max_feat: int = 512, min_score: float = 5e-4, nms_radius: int = 6):
    """The native visual-feature stage (the reference's
    src/visual_feature_node.cpp: corners + robust depth + plane fit).
    Returns (n, uv (F, 2), score (F,), z (F,), z_var (F,), normal_duv1
    (F, 3), gray01 (F,)), all float32; the first n rows are features."""
    g = np.ascontiguousarray(gray_u8, dtype=np.uint8)
    d = np.ascontiguousarray(depth_f32, dtype=np.float32)
    H, W = g.shape
    F = int(max_feat)
    uv = np.zeros((F, 2), dtype=np.float32)
    score, z, zvar, color = (np.zeros(F, dtype=np.float32) for _ in range(4))
    normal = np.zeros((F, 3), dtype=np.float32)
    n = library().gcslam_visual_features(
        _ptr(g, ctypes.c_uint8), _ptr(d, ctypes.c_float), W, H, F, ctypes.c_float(min_score), nms_radius,
        _ptr(uv, ctypes.c_float), _ptr(score, ctypes.c_float), _ptr(z, ctypes.c_float), _ptr(zvar, ctypes.c_float),
        _ptr(normal, ctypes.c_float), _ptr(color, ctypes.c_float),
    )
    return int(n), uv, score, z, zvar, normal, color


def stream_pointclouds(db_path: str, topic: str, max_points: int, sentinel: float,
                       queue_depth: int = 4) -> Iterator[tuple]:
    """Async PointCloud2 stream over a rosbag2 sqlite container: a native
    worker thread reads the topic's rows and parses them while the consumer
    assembles batches (the reference's async LiDAR worker,
    backend_node.py:1340-1388). Yields (xyz f32 (n, 3), t f64 (n,), ring
    i32, tag i32, stamp, bag_t); closing the generator joins the worker. A
    row the decoder could not parse raises at the end of the stream."""
    lib = library()
    h = lib.gcslam_stream_open(db_path.encode(), topic.encode(), max_points, float(sentinel), queue_depth)
    if not h:
        raise RuntimeError("native streamer: libsqlite3.so.0 could not be loaded")
    # one receive buffer; the yielded arrays are copies of its filled rows
    xyz = np.empty((max_points, 3), np.float32)
    t = np.empty(max_points, np.float64)
    ring = np.empty(max_points, np.int32)
    tag = np.empty(max_points, np.int32)
    try:
        while True:
            stamp, bag_t = ctypes.c_double(0.0), ctypes.c_double(0.0)
            n = lib.gcslam_stream_next(h, _ptr(xyz, ctypes.c_float), _ptr(t, ctypes.c_double),
                                       _ptr(ring, ctypes.c_int32), _ptr(tag, ctypes.c_int32),
                                       ctypes.byref(stamp), ctypes.byref(bag_t))
            if n < 0:
                break
            yield xyz[:n].copy(), t[:n].copy(), ring[:n].copy(), tag[:n].copy(), float(stamp.value), float(bag_t.value)
        skipped = lib.gcslam_stream_skipped(h)
        if skipped:
            raise ValueError(f"native streamer: {skipped} {topic} rows of {db_path} could not be parsed")
    finally:
        lib.gcslam_stream_close(h)
