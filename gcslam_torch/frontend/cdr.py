"""Minimal CDR (Common Data Representation) codec for ROS 2 messages
(the port's own copy of the JAX package's frontend/cdr.py; numpy only).

Replaces the rclpy/rosbag2 dependency: rosbag2 sqlite bags store raw
CDR-encoded payloads (4-byte encapsulation header + XCDR1 little-endian
body). This module decodes exactly the message types the pipeline consumes
(reference topics, docs/KIMERA_DATASET_AND_PIPELINE.md):

    sensor_msgs/msg/PointCloud2, sensor_msgs/msg/Imu, nav_msgs/msg/Odometry,
    sensor_msgs/msg/Image, sensor_msgs/msg/CompressedImage

plus an encoder for the same types so tests can synthesize valid bags.
Alignment follows XCDR1: primitives align to min(size, 8) relative to the
body start; strings carry a trailing NUL included in their length.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


class CdrReader:
    def __init__(self, buf: bytes):
        # encapsulation: {0x00, 0x01}=BE/LE CDR, 2 bytes options
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        self.le = buf[1] in (0x01, 0x03)
        self.buf = buf
        self.off = 4

    def _align(self, size: int):
        rel = self.off - 4
        pad = (-rel) % size
        self.off += pad

    def _unpack(self, fmt: str, size: int):
        self._align(size)
        (v,) = struct.unpack_from(("<" if self.le else ">") + fmt, self.buf, self.off)
        self.off += size
        return v

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def b(self):
        return bool(self.u8())

    def u16(self):
        return self._unpack("H", 2)

    def i32(self):
        return self._unpack("i", 4)

    def u32(self):
        return self._unpack("I", 4)

    def u64(self):
        return self._unpack("Q", 8)

    def f32(self):
        return self._unpack("f", 4)

    def f64(self):
        return self._unpack("d", 8)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s[:-1].decode("utf-8", "replace") if n else ""

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, dtype="<f8" if self.le else ">f8", count=n, offset=self.off)
        self.off += 8 * n
        return np.asarray(out)

    def byte_seq(self) -> bytes:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s


class CdrWriter:
    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")  # LE CDR

    def _align(self, size: int):
        rel = len(self.parts) - 4
        self.parts.extend(b"\x00" * ((-rel) % size))

    def _pack(self, fmt: str, size: int, v):
        self._align(size)
        self.parts.extend(struct.pack("<" + fmt, v))

    def u8(self, v):
        self.parts.append(v & 0xFF)

    def u16(self, v):
        self._pack("H", 2, v)

    def i32(self, v):
        self._pack("i", 4, v)

    def u32(self, v):
        self._pack("I", 4, v)

    def f64(self, v):
        self._pack("d", 8, v)

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts.extend(b)

    def f64_array(self, arr):
        self._align(8)
        self.parts.extend(np.asarray(arr, dtype="<f8").tobytes())

    def byte_seq(self, b: bytes):
        self.u32(len(b))
        self.parts.extend(b)

    def tobytes(self) -> bytes:
        return bytes(self.parts)


# ---------------------------------------------------------------------------
# Message structs
# ---------------------------------------------------------------------------


@dataclass
class Header:
    stamp_sec: float = 0.0
    frame_id: str = ""


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


@dataclass
class PointCloud2:
    header: Header
    height: int
    width: int
    fields: List[PointField]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool


@dataclass
class Imu:
    header: Header
    orientation: np.ndarray  # (4,) xyzw
    angular_velocity: np.ndarray  # (3,)
    linear_acceleration: np.ndarray  # (3,)
    angular_velocity_cov: np.ndarray = field(default_factory=lambda: np.zeros(9))
    linear_acceleration_cov: np.ndarray = field(default_factory=lambda: np.zeros(9))


@dataclass
class Image:
    """sensor_msgs/msg/Image (reference camera_rgbd_node.cpp:175 consumes
    16UC1/32FC1 depth; visual_feature_node.cpp consumes rgb8/bgr8)."""

    header: Header
    height: int
    width: int
    encoding: str  # "rgb8" | "bgr8" | "mono8" | "16UC1" | "32FC1"
    is_bigendian: bool
    step: int
    data: bytes


@dataclass
class CompressedImage:
    """sensor_msgs/msg/CompressedImage (reference camera_rgbd_node.cpp:145
    decodes JPEG-compressed RGB)."""

    header: Header
    format: str  # e.g. "jpeg", "rgb8; jpeg compressed bgr8"
    data: bytes


@dataclass
class CameraInfo:
    """sensor_msgs/msg/CameraInfo (intrinsics live on the bag, not just the
    calibration YAML — reference camera_rgbd_node.cpp subscribes it)."""

    header: Header
    height: int
    width: int
    distortion_model: str
    d: np.ndarray  # (n,) distortion coefficients
    k: np.ndarray  # (9,) row-major 3x3 intrinsics
    r: np.ndarray  # (9,)
    p: np.ndarray  # (12,) projection
    binning_x: int = 0
    binning_y: int = 0


@dataclass
class Odometry:
    header: Header
    child_frame_id: str
    position: np.ndarray  # (3,)
    orientation: np.ndarray  # (4,) xyzw
    pose_cov: np.ndarray  # (36,)
    twist_linear: np.ndarray  # (3,)
    twist_angular: np.ndarray  # (3,)
    twist_cov: np.ndarray  # (36,)


def _read_header(r: CdrReader) -> Header:
    sec = r.i32()
    nsec = r.u32()
    return Header(stamp_sec=sec + nsec * 1e-9, frame_id=r.string())


def _write_header(w: CdrWriter, stamp_sec: float, frame_id: str = "f"):
    w.i32(int(stamp_sec))
    w.u32(int(round((stamp_sec - int(stamp_sec)) * 1e9)))
    w.string(frame_id)


def parse_pointcloud2(buf: bytes) -> PointCloud2:
    r = CdrReader(buf)
    h = _read_header(r)
    height, width = r.u32(), r.u32()
    n_fields = r.u32()
    fields = []
    for _ in range(n_fields):
        fields.append(PointField(r.string(), r.u32(), r.u8(), r.u32()))
    is_be = r.b()
    point_step, row_step = r.u32(), r.u32()
    data = r.byte_seq()
    is_dense = r.b()
    return PointCloud2(h, height, width, fields, is_be, point_step, row_step, data, is_dense)


def serialize_pointcloud2(msg: PointCloud2) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.header.stamp_sec, msg.header.frame_id)
    w.u32(msg.height)
    w.u32(msg.width)
    w.u32(len(msg.fields))
    for f in msg.fields:
        w.string(f.name)
        w.u32(f.offset)
        w.u8(f.datatype)
        w.u32(f.count)
    w.u8(int(msg.is_bigendian))
    w.u32(msg.point_step)
    w.u32(msg.row_step)
    w.byte_seq(msg.data)
    w.u8(int(msg.is_dense))
    return w.tobytes()


def parse_imu(buf: bytes) -> Imu:
    r = CdrReader(buf)
    h = _read_header(r)
    quat = r.f64_array(4)
    _ocov = r.f64_array(9)
    ang = r.f64_array(3)
    acov = r.f64_array(9)
    lin = r.f64_array(3)
    lcov = r.f64_array(9)
    return Imu(h, quat, ang, lin, acov, lcov)


def serialize_imu(msg: Imu) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.header.stamp_sec, msg.header.frame_id)
    w.f64_array(msg.orientation)
    w.f64_array(np.zeros(9))
    w.f64_array(msg.angular_velocity)
    w.f64_array(msg.angular_velocity_cov)
    w.f64_array(msg.linear_acceleration)
    w.f64_array(msg.linear_acceleration_cov)
    return w.tobytes()


def parse_image(buf: bytes) -> Image:
    r = CdrReader(buf)
    h = _read_header(r)
    height, width = r.u32(), r.u32()
    encoding = r.string()
    is_be = r.b()
    step = r.u32()
    data = r.byte_seq()
    return Image(h, height, width, encoding, is_be, step, data)


def serialize_image(msg: Image) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.header.stamp_sec, msg.header.frame_id)
    w.u32(msg.height)
    w.u32(msg.width)
    w.string(msg.encoding)
    w.u8(int(msg.is_bigendian))
    w.u32(msg.step)
    w.byte_seq(msg.data)
    return w.tobytes()


def parse_compressed_image(buf: bytes) -> CompressedImage:
    r = CdrReader(buf)
    h = _read_header(r)
    fmt = r.string()
    data = r.byte_seq()
    return CompressedImage(h, fmt, data)


def serialize_compressed_image(msg: CompressedImage) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.header.stamp_sec, msg.header.frame_id)
    w.string(msg.format)
    w.byte_seq(msg.data)
    return w.tobytes()


def parse_camera_info(buf: bytes) -> CameraInfo:
    r = CdrReader(buf)
    h = _read_header(r)
    height, width = r.u32(), r.u32()
    model = r.string()
    n_d = r.u32()  # d is a sequence; k/r/p are fixed-size arrays
    d = r.f64_array(n_d)
    k = r.f64_array(9)
    rm = r.f64_array(9)
    p = r.f64_array(12)
    bx, by = r.u32(), r.u32()
    return CameraInfo(h, height, width, model, d, k, rm, p, bx, by)


def serialize_camera_info(msg: CameraInfo) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.header.stamp_sec, msg.header.frame_id)
    w.u32(msg.height)
    w.u32(msg.width)
    w.string(msg.distortion_model)
    w.u32(len(np.asarray(msg.d)))
    w.f64_array(msg.d)
    w.f64_array(msg.k)
    w.f64_array(msg.r)
    w.f64_array(msg.p)
    w.u32(msg.binning_x)
    w.u32(msg.binning_y)
    # roi: x_offset, y_offset, height, width, do_rectify
    w.u32(0), w.u32(0), w.u32(0), w.u32(0)
    w.u8(0)
    return w.tobytes()


def image_stamp(buf: bytes) -> float:
    """Header stamp without decoding pixel data (cheap pairing pass)."""
    r = CdrReader(buf)
    return _read_header(r).stamp_sec


def header_stamp(buf: bytes) -> float:
    """Header stamp of ANY std_msgs/Header-led message (every sensor msg the
    pipeline consumes starts with a header)."""
    r = CdrReader(buf)
    return _read_header(r).stamp_sec


def parse_odometry(buf: bytes) -> Odometry:
    r = CdrReader(buf)
    h = _read_header(r)
    child = r.string()
    pos = r.f64_array(3)
    quat = r.f64_array(4)
    pcov = r.f64_array(36)
    tl = r.f64_array(3)
    ta = r.f64_array(3)
    tcov = r.f64_array(36)
    return Odometry(h, child, pos, quat, pcov, tl, ta, tcov)


def serialize_odometry(msg: Odometry) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.header.stamp_sec, msg.header.frame_id)
    w.string(msg.child_frame_id)
    w.f64_array(msg.position)
    w.f64_array(msg.orientation)
    w.f64_array(msg.pose_cov)
    w.f64_array(msg.twist_linear)
    w.f64_array(msg.twist_angular)
    w.f64_array(msg.twist_cov)
    return w.tobytes()


# ---------------------------------------------------------------------------
# VLP-16 PointCloud2 -> arrays (reference backend_node.parse_pointcloud2_vlp16)
# ---------------------------------------------------------------------------

_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}


def pointcloud2_to_arrays(msg: PointCloud2) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (points (N,3) f64, per-point stamps (N,) f64, ring (N,) i32, tag (N,) i32).

    Per-point time from the 't'/'time' field (s or ns, auto-detected) else the
    header stamp; NaN/Inf replaced by the finite sentinel (reference
    backend_node.py:377-468)."""
    from gcslam_torch import constants as C

    n = msg.width * msg.height
    if n == 0:
        z = np.zeros((0,))
        return np.zeros((0, 3)), z, z.astype(np.int32), z.astype(np.int32)
    fmap = {f.name: f for f in msg.fields}
    end = ">" if msg.is_bigendian else "<"

    def col(name, dt_default="f4"):
        f = fmap[name]
        dt = np.dtype(end + _PF_DTYPES.get(f.datatype, dt_default))
        raw = np.frombuffer(msg.data, dtype=np.uint8).reshape(n, msg.point_step)
        return raw[:, f.offset : f.offset + dt.itemsize].copy().view(dt)[:, 0]

    sentinel = C.NONFINITE_SENTINEL
    xyz = np.stack(
        [np.nan_to_num(col(a).astype(np.float64), nan=sentinel, posinf=sentinel, neginf=-sentinel)
         for a in ("x", "y", "z")],
        axis=1,
    )
    ring = col("ring").astype(np.int32) if "ring" in fmap else np.zeros(n, np.int32)
    tag = col("tag").astype(np.int32) if "tag" in fmap else np.zeros(n, np.int32)
    tname = "t" if "t" in fmap else ("time" if "time" in fmap else None)
    if tname is not None:
        t = col(tname).astype(np.float64)
        if np.any(t > 1e6):  # nanoseconds
            t = t * 1e-9
        if np.all(t < 1e5):  # relative to header stamp
            t = t + msg.header.stamp_sec
    else:
        t = np.full(n, msg.header.stamp_sec)
    return xyz, t, ring, tag
