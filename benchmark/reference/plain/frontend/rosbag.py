"""Offline rosbag2 reader -> fixed-shape ScanBatch stream (counterpart of
the JAX package's frontend/rosbag.py).

Replaces the reference's ROS 2 graph (launch/gc_rosbag.launch.py +
gc_sensor_hub + backend subscriptions + ring buffers + scan clock,
backend_node.py:939-2035) with a deterministic offline pass:

  - the container (rosbag2 sqlite .db3 or MCAP) and the CDR payloads are
    decoded by the native library (frontend/native.py): on a .db3 a C++
    worker thread streams and parses the LiDAR topic while batches are
    assembled, and the IMU and odometry streams are parsed in one batch
    call each; the camera's corner, depth and plane stage runs there too.
    JPEG frames decode with PIL. The pure-Python CDR codec
    (frontend/cdr.py) with the pure camera route runs only when the caller
    asks for it (`load_bag(..., native=False)`) or sets GCSLAM_NO_NATIVE=1,
    the JAX package's switch;
  - scan clock: each LiDAR message makes exactly one ScanBatch, faster
    streams are sliced into windows at scan boundaries;
  - deterministic point-budget resample to the batch's point budget (the
    reference's PointBudgetResample, operators/point_budget.py:51-221);
  - extrinsic transforms into the base frame, IMU accel scaling, per-topic
    time alignment;
  - anchor from the first odometry (smoothed over the first K odoms with
    IMU-stability weights, backend_node.py:1467-1513), odom z-variance floor.

Everything up to the batch is numpy on the host; each batch is built with
scan_io.batch_from_numpy on `device` (default: the CUDA card), and the
camera features are lifted in torch on that device.
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.frontend import cdr
from benchmark.reference.plain.frontend.time_alignment import TopicAlignment
from benchmark.reference.plain.models.config import read_config_mapping
from benchmark.reference.plain.models.scan_io import ScanBatch, batch_from_numpy, range_weights
from benchmark.reference.plain.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BagConfig:
    lidar_topic: Optional[str] = None  # None: first PointCloud2 topic
    imu_topic: Optional[str] = None
    odom_topic: Optional[str] = None
    T_base_lidar: Tuple[float, ...] = (0.0,) * 6  # [t(3), rotvec(3)]
    T_base_imu: Tuple[float, ...] = (0.0,) * 6
    imu_accel_scale: float = 1.0  # 9.81 for g-reporting IMUs
    n_points: int = C.N_POINTS_CAP
    max_scans: Optional[int] = None
    min_range_m: float = 0.4  # sensor-frame no-return/self-return cutoff
    anchor_smoothing_k: int = 10
    alignment: Optional[Dict[str, TopicAlignment]] = None
    # RGB-D camera (reference config/gc_unified.yaml camera section +
    # src/camera_rgbd_node.cpp pairing contract)
    with_camera: bool = False
    rgb_topic: Optional[str] = None  # None: first CompressedImage topic
    depth_topic: Optional[str] = None  # None: first 16UC1/32FC1 Image topic
    T_base_camera: Tuple[float, ...] = (0.0,) * 6
    camera_intrinsics: Optional[Tuple[float, float, float, float]] = None  # fx fy cx cy
    depth_scale_16u: float = 0.001  # 16UC1 mm -> m
    cam_pair_max_dt: float = 0.05  # rgb<->depth pairing window (s)
    cam_scan_max_dt: float = 0.15  # paired-frame<->scan window (s)


def bag_config_from_dict(d: dict, base_dir: str = ".") -> BagConfig:
    """BagConfig from the config file's `frontend:` section (the reference's
    topics/extrinsics/camera/time-alignment config,
    config/gc_unified.yaml:1-135). Unknown keys fail fast;
    `time_alignment_path` loads a profile file."""
    from benchmark.reference.plain.frontend.time_alignment import load_alignment

    d = dict(d)
    align_path = d.pop("time_alignment_path", None)
    known = {f.name for f in dataclasses.fields(BagConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"frontend config: unknown BagConfig keys: {unknown}")
    for key in ("T_base_lidar", "T_base_imu", "T_base_camera"):
        if key in d:
            v = tuple(float(x) for x in d[key])
            if len(v) != 6:
                raise ValueError(f"frontend.{key} must have 6 entries [t(3), rotvec(3)]")
            d[key] = v
    if d.get("camera_intrinsics") is not None:
        v = tuple(float(x) for x in d["camera_intrinsics"])
        if len(v) != 4:
            raise ValueError("frontend.camera_intrinsics must be (fx, fy, cx, cy)")
        d["camera_intrinsics"] = v
    if align_path is not None:
        if not os.path.isabs(align_path):
            align_path = os.path.join(base_dir, align_path)
        d["alignment"] = load_alignment(align_path)
    return BagConfig(**d)


def bag_config_from_file(path: str) -> Optional[BagConfig]:
    """The `frontend:` section of the run config; None when the file has no
    such section (synthetic runs need no bag config)."""
    fe = (read_config_mapping(path) or {}).get("frontend")
    if fe is None:
        return None
    return bag_config_from_dict(fe, base_dir=os.path.dirname(os.path.abspath(path)))


def _rotvec_R(rv) -> np.ndarray:
    rv = np.asarray(rv, dtype=np.float64)
    th = np.linalg.norm(rv)
    if th < 1e-12:
        return np.eye(3)
    k = rv / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _quat_to_rotvec(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    q = q / max(np.linalg.norm(q), 1e-12)
    xyz, w = q[:3], q[3]
    n = np.linalg.norm(xyz)
    theta = 2.0 * np.arctan2(n, w)
    if theta > np.pi:
        theta -= 2 * np.pi
    return xyz * (theta / n if n > 1e-12 else 2.0)


def cdrless_rotvec(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R)
    cos = np.clip(0.5 * (tr - 1), -1, 1)
    vex = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin = np.linalg.norm(vex)
    theta = np.arctan2(sin, cos)
    return vex * (theta / sin if sin > 1e-9 else 1.0)


def read_bag_messages(db_path: str, exclude: Tuple[str, ...] = ()) -> Dict[str, List[Tuple[float, bytes]]]:
    """topic -> [(bag_time_sec, raw_cdr)] sorted by time, plus '__types__'
    (topic -> message type). Dispatches on the container: rosbag2 sqlite
    (.db3) or MCAP (.mcap). Topics in `exclude` keep their (empty) entry and
    type but their payloads are not loaded (the native streamer reads them
    out of the container itself)."""
    if db_path.endswith(".mcap"):
        from benchmark.reference.plain.frontend.mcap import read_mcap_messages

        return read_mcap_messages(db_path)
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    topics = {tid: (name, typ) for tid, name, typ in conn.execute("SELECT id, name, type FROM topics")}
    out: Dict[str, List[Tuple[float, bytes]]] = {name: [] for name, _ in topics.values()}
    skip_ids = {tid for tid, (name, _) in topics.items() if name in exclude}
    for tid, ts, data in conn.execute("SELECT topic_id, timestamp, data FROM messages ORDER BY timestamp"):
        if tid in skip_ids:
            continue
        out[topics[tid][0]].append((ts * 1e-9, bytes(data)))
    conn.close()
    out["__types__"] = {name: typ for name, typ in topics.values()}  # type: ignore
    return out


def bag_topic_summary(db_path: str) -> Dict[str, Tuple[str, int]]:
    """topic -> (type, message_count) without loading payloads (.db3 only)."""
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    topics = {tid: (name, typ) for tid, name, typ in conn.execute("SELECT id, name, type FROM topics")}
    counts = dict(conn.execute("SELECT topic_id, COUNT(*) FROM messages GROUP BY topic_id"))
    conn.close()
    return {name: (typ, int(counts.get(tid, 0))) for tid, (name, typ) in topics.items()}


def point_budget_resample(
    points: np.ndarray, stamps: np.ndarray, weights: np.ndarray,
    ring: np.ndarray, tag: np.ndarray, n_cap: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic subsample with total-mass preservation (reference
    operators/point_budget.py:51-221).

    Not a stride: VLP-16 clouds are ring-interleaved (the firing order
    cycles the 16 lasers), so a stride-2 subsample keeps only the 8 even
    rings and surfel normals degenerate. A fixed-seed permutation is
    deterministic across runs and fair to any interleaving."""
    n = points.shape[0]
    if n > n_cap:
        idx = np.sort(np.random.default_rng(0x5EED).permutation(n)[:n_cap])
    else:
        idx = np.arange(n)
    total_in = float(weights.sum())
    w_sel = weights[idx]
    scale = total_in / (float(w_sel.sum()) + C.EPS_MASS)
    out_p = np.zeros((n_cap, 3))
    out_t = np.zeros(n_cap)
    out_w = np.zeros(n_cap)
    out_r = np.zeros(n_cap, np.int32)
    out_g = np.zeros(n_cap, np.int32)
    k = min(len(idx), n_cap)
    out_p[:k] = points[idx][:k]
    out_t[:k] = stamps[idx][:k]
    out_w[:k] = (w_sel * scale)[:k]
    out_r[:k] = ring[idx][:k]
    out_g[:k] = tag[idx][:k]
    return out_p, out_t, out_w, out_r, out_g


def _smoothed_anchor(odom_t: np.ndarray, odom_pos: np.ndarray, odom_quat: np.ndarray,
                     imu_t: np.ndarray, imu_gyro: np.ndarray, imu_accel: np.ndarray, k: int) -> np.ndarray:
    """IMU-stability-weighted mean of the first k odom poses
    (backend_node.py:1477-1513): w ~ exp(-c_g |w|^2) exp(-c_a (|a| - g)^2);
    translation = weighted mean, rotation = polar mean. The stamps are the
    messages' header stamps (before alignment)."""
    k = min(k, len(odom_t))
    if k == 0:
        return np.zeros(6)
    poses = np.asarray([np.concatenate([odom_pos[i], _quat_to_rotvec(odom_quat[i])]) for i in range(k)])
    ws = np.ones(k)
    if len(imu_t):
        for i in range(k):
            j = int(np.argmin(np.abs(imu_t - odom_t[i])))
            gy = np.linalg.norm(imu_gyro[j])
            ac = np.linalg.norm(imu_accel[j])
            ws[i] = np.exp(-C.INIT_ANCHOR_GYRO_SCALE * gy**2) * np.exp(
                -C.INIT_ANCHOR_ACCEL_SCALE * (ac - C.GRAVITY_MAG) ** 2)
    ws = ws / max(ws.sum(), 1e-12)
    t_mean = (poses[:, :3] * ws[:, None]).sum(0)
    Rs = np.stack([_rotvec_R(p[3:6]) for p in poses])
    M = (Rs * ws[:, None, None]).sum(0)
    U, _, Vt = np.linalg.svd(M)
    fix = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return np.concatenate([t_mean, cdrless_rotvec(U @ fix @ Vt)])


class _CameraStream:
    """Lazy RGB-D frame store: pairs rgb/depth messages by stamp, and
    decodes and extracts features only for the frames a scan consumes (the
    offline fusion of the reference's camera_rgbd_node +
    visual_feature_node)."""

    def __init__(self, rgb_msgs, rgb_is_compressed, depth_msgs, cfg: BagConfig,
                 rgb_stamps, depth_stamps, native: bool, device):
        from benchmark.reference.plain.frontend import images
        from benchmark.reference.plain.frontend.camera import PinholeIntrinsics

        self.rgb_msgs = rgb_msgs
        self.rgb_is_compressed = rgb_is_compressed
        self.depth_msgs = depth_msgs
        self.cfg = cfg
        self.native = native
        self.device = device
        self.pairs = images.pair_rgbd(np.asarray(rgb_stamps), np.asarray(depth_stamps), cfg.cam_pair_max_dt)
        self.pair_t = np.asarray([t for _, _, t in self.pairs])
        fx, fy, cx, cy = cfg.camera_intrinsics  # validated by the caller
        self.intr = PinholeIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy)
        self.R_bc = _rotvec_R(cfg.T_base_camera[3:6])
        self.t_bc = np.asarray(cfg.T_base_camera[:3])
        self._cache: Dict[int, tuple] = {}

    def features_for(self, t_scan: float, points_base: np.ndarray, weights: np.ndarray):
        """Nearest paired frame within cam_scan_max_dt -> base-frame
        CameraFeatures on the device, or None when no frame is close enough."""
        import torch

        from benchmark.reference.plain.frontend import camera as cam_mod, images

        if len(self.pair_t) == 0:
            return None
        i = int(np.argmin(np.abs(self.pair_t - t_scan)))
        if abs(self.pair_t[i] - t_scan) > self.cfg.cam_scan_max_dt:
            return None
        if i not in self._cache:
            ri, dj, _ = self.pairs[i]
            rgb_raw = self.rgb_msgs[ri]
            if self.rgb_is_compressed:
                rgb = images.decode_compressed(cdr.parse_compressed_image(rgb_raw))
            else:
                rgb = np.asarray(images.image_to_array(cdr.parse_image(rgb_raw)))
            depth = images.depth_to_meters(cdr.parse_image(self.depth_msgs[dj]), self.cfg.depth_scale_16u)
            if rgb.shape[:2] != depth.shape[:2]:
                raise ValueError(
                    f"rgb {rgb.shape[:2]} vs depth {depth.shape[:2]} size mismatch; the pipeline requires "
                    "registered RGB-D (reference camera_rgbd_node.cpp pairs same-resolution streams)")
            self._cache.clear()  # keep at most one decoded frame resident
            self._cache[i] = (images.to_gray01(rgb), depth, rgb.astype(np.float32) / 255.0)
        gray, depth, rgb01 = self._cache[i]

        # base-frame LiDAR -> camera frame for the Route A/B depth fusion
        lidar_cam = (points_base - self.t_bc[None, :]) @ self.R_bc
        if True:  # the corner stage's numpy mirror (frontend/native.visual_features)
            feats = cam_mod.extract_camera_features_native(
                gray, depth, rgb01, self.intr, lidar_cam, weights, n_feat=C.N_FEAT, device=self.device)
        else:
            def t(x):
                return torch.as_tensor(x, device=self.device)

            feats = cam_mod.extract_camera_features(t(gray), t(depth), t(rgb01), self.intr, t(lidar_cam),
                                                    t(weights), n_feat=C.N_FEAT)
        return cam_mod.features_to_base_frame(feats, self.cfg.T_base_camera)


def _find_camera_topics(raw, types, cfg: BagConfig):
    """-> (rgb_topic, rgb_is_compressed, depth_topic). Raises when
    with_camera is set and the bag carries no usable camera streams (a
    camera path that is dead by silence is refused)."""
    rgb_topic, rgb_compressed = cfg.rgb_topic, None
    if rgb_topic is not None:
        rgb_compressed = "CompressedImage" in types.get(rgb_topic, "")
    else:
        for name, typ in types.items():
            if "CompressedImage" in typ and raw.get(name):
                rgb_topic, rgb_compressed = name, True
                break
        if rgb_topic is None:
            for name, typ in types.items():
                if typ.endswith("msg/Image") and raw.get(name):
                    if cdr.parse_image(raw[name][0][1]).encoding.lower() in ("rgb8", "bgr8", "mono8"):
                        rgb_topic, rgb_compressed = name, False
                        break
    depth_topic = cfg.depth_topic
    if depth_topic is None:
        for name, typ in types.items():
            if typ.endswith("msg/Image") and raw.get(name) and name != rgb_topic:
                if cdr.parse_image(raw[name][0][1]).encoding.lower() in ("16uc1", "mono16", "32fc1"):
                    depth_topic = name
                    break
    if rgb_topic is None or depth_topic is None:
        raise ValueError(
            f"with_camera=True but bag has no usable RGB-D streams "
            f"(rgb={rgb_topic}, depth={depth_topic}); topics: {list(types)}")
    return rgb_topic, bool(rgb_compressed), depth_topic


def _decode_imu(bufs: List[bytes], native: bool):
    """-> (header stamps (n,), gyro (n, 3), accel (n, 3)), sensor frame."""
    if native:
        from benchmark.reference.plain.frontend.native import parse_imu_batch

        return parse_imu_batch(bufs)
    msgs = [cdr.parse_imu(b) for b in bufs]
    return (np.asarray([m.header.stamp_sec for m in msgs], dtype=np.float64),
            np.asarray([m.angular_velocity for m in msgs], dtype=np.float64).reshape(-1, 3),
            np.asarray([m.linear_acceleration for m in msgs], dtype=np.float64).reshape(-1, 3))


def _decode_odometry(bufs: List[bytes], native: bool):
    """-> (header stamps, pos (n, 3), quat (n, 4), pose_cov (n, 36),
    twist (n, 6), twist_cov (n, 36))."""
    if native:
        from benchmark.reference.plain.frontend.native import parse_odometry_batch

        return parse_odometry_batch(bufs)
    msgs = [cdr.parse_odometry(b) for b in bufs]

    def stack(get, width):
        return np.asarray([get(m) for m in msgs], dtype=np.float64).reshape(-1, width)

    return (np.asarray([m.header.stamp_sec for m in msgs], dtype=np.float64),
            stack(lambda m: m.position, 3), stack(lambda m: m.orientation, 4), stack(lambda m: m.pose_cov, 36),
            stack(lambda m: np.concatenate([m.twist_linear, m.twist_angular]), 6), stack(lambda m: m.twist_cov, 36))


def load_bag(
    db_path: str,
    n_points: int = C.N_POINTS_CAP,
    config: BagConfig | None = None,
    device=None,
    native: Optional[bool] = None,
) -> Tuple[List[ScanBatch], Optional[np.ndarray], Optional[np.ndarray]]:
    """-> (batches on `device` (default: the CUDA card), gt_poses=None,
    gt_times=None). Ground truth comes from a separate TUM file in real
    evaluations. `native=False` decodes with the pure-Python CDR codec and
    the pure camera route; `native=None` takes the native route unless
    GCSLAM_NO_NATIVE=1 (the JAX package's switch); nothing switches to the
    Python route by itself."""
    from benchmark.reference.plain.frontend import native as native_mod

    device = resolve_device(device)
    native = False  # the reference decodes with the pure-Python CDR codec
    cfg = config or BagConfig(n_points=n_points)

    # On a .db3 the native streamer reads and parses the LiDAR topic (the
    # bulk of the bag's bytes) in a worker thread: resolve the topic from
    # the container's directory and leave its payloads out of the bulk read.
    stream_lidar_topic: Optional[str] = None
    if native and db_path.endswith(".db3"):
        summary = bag_topic_summary(db_path)
        stream_lidar_topic = cfg.lidar_topic or next(
            (n for n, (typ, cnt) in summary.items() if "PointCloud2" in typ and cnt > 0), None)
    raw = read_bag_messages(db_path, exclude=(stream_lidar_topic,) if stream_lidar_topic else ())
    types: Dict[str, str] = raw.pop("__types__")  # type: ignore

    def find_topic(want: Optional[str], type_frag: str) -> Optional[str]:
        if want is not None:
            return want
        for name, typ in types.items():
            if type_frag in typ and (raw.get(name) or name == stream_lidar_topic):
                return name
        return None

    lidar_topic = find_topic(cfg.lidar_topic, "PointCloud2")
    imu_topic = find_topic(cfg.imu_topic, "Imu")
    odom_topic = find_topic(cfg.odom_topic, "Odometry")
    if lidar_topic is None:
        raise ValueError(f"no PointCloud2 topic in bag; topics: {list(types)}")

    align = cfg.alignment or {}

    def aligned(topic: str, t: float) -> float:
        a = align.get(topic)
        return float(a.apply(np.asarray(t))) if a else t

    imu_st, imu_gyro, imu_accel = _decode_imu([b for _, b in raw.get(imu_topic, [])] if imu_topic else [], native)
    odom_st, odom_pos, odom_quat, odom_pcov, odom_tw, odom_tcov = _decode_odometry(
        [b for _, b in raw.get(odom_topic, [])] if odom_topic else [], native)
    imu_t = np.asarray([aligned(imu_topic, float(s)) for s in imu_st])
    odom_t = np.asarray([aligned(odom_topic, float(s)) for s in odom_st])

    # RGB-D camera streams (offline camera_rgbd_node + visual_feature_node)
    cam_stream: Optional[_CameraStream] = None
    if cfg.with_camera:
        if cfg.camera_intrinsics is None:
            raise ValueError("with_camera=True requires camera_intrinsics=(fx, fy, cx, cy) "
                             "(reference config/gc_unified.yaml camera_k)")
        rgb_topic, rgb_comp, depth_topic = _find_camera_topics(raw, types, cfg)
        rgb_msgs = [b for _, b in raw[rgb_topic]]
        depth_msgs = [b for _, b in raw[depth_topic]]
        rgb_stamps = [aligned(rgb_topic, cdr.image_stamp(b)) for b in rgb_msgs]
        depth_stamps = [aligned(depth_topic, cdr.image_stamp(b)) for b in depth_msgs]
        cam_stream = _CameraStream(rgb_msgs, rgb_comp, depth_msgs, cfg, rgb_stamps, depth_stamps, native, device)
        if not cam_stream.pairs:
            raise ValueError(f"with_camera=True but no rgb/depth pair within {cfg.cam_pair_max_dt}s "
                             f"({len(rgb_msgs)} rgb, {len(depth_msgs)} depth messages)")

    # Anchor: the smoothed initial odom pose; odom poses are reported
    # relative to it (backend_node.py:1515-1517) so the filter's identity
    # prior matches the first pose.
    anchor = _smoothed_anchor(odom_st, odom_pos, odom_quat, imu_st, imu_gyro, imu_accel, cfg.anchor_smoothing_k)
    R_a = _rotvec_R(anchor[3:6])
    R_bl = _rotvec_R(cfg.T_base_lidar[3:6])
    t_bl = np.asarray(cfg.T_base_lidar[:3])
    R_bi = _rotvec_R(cfg.T_base_imu[3:6])

    def lidar_scans():
        """Yield (xyz f64 (n, 3) lidar frame, pt_t, ring, tag, t_scan)."""
        if stream_lidar_topic is not None:
            for xyz32, pt_t, ring, tag, stamp, _bag_t in native_mod.stream_pointclouds(
                    db_path, stream_lidar_topic, 1 << 20, C.NONFINITE_SENTINEL):
                yield xyz32.astype(np.float64), pt_t, ring, tag, aligned(lidar_topic, stamp)
            return
        for _bag_t, buf in raw[lidar_topic]:
            if native:
                xyz32, pt_t, ring, tag, stamp = native_mod.parse_pointcloud2(buf, 1 << 20, C.NONFINITE_SENTINEL)
                yield xyz32.astype(np.float64), pt_t, ring, tag, aligned(lidar_topic, stamp)
            else:
                msg = cdr.parse_pointcloud2(buf)
                xyz, pt_t, ring, tag = cdr.pointcloud2_to_arrays(msg)
                yield xyz, pt_t, ring, tag, aligned(lidar_topic, msg.header.stamp_sec)

    batches: List[ScanBatch] = []
    t_last_scan = None
    prev_odom_idx = None
    scan_iter = lidar_scans()
    for k, (xyz, pt_t, ring, tag, t_scan) in enumerate(scan_iter):
        if cfg.max_scans is not None and k >= cfg.max_scans:
            scan_iter.close()  # joins the native worker when streaming
            break
        # No-return mask BEFORE the extrinsic transform: drivers encode
        # missed returns as (0, 0, 0) in the sensor frame, which after the
        # T_base_lidar shift would become a ghost cluster at the robot. The
        # min-range gate also drops self-returns.
        r_sensor = np.linalg.norm(xyz, axis=1)
        valid_pt = np.isfinite(r_sensor) & (r_sensor > cfg.min_range_m)
        xyz = np.where(np.isfinite(xyz), xyz, 0.0) @ R_bl.T + t_bl[None, :]
        w = range_weights(np.linalg.norm(xyz, axis=1)) * valid_pt
        p, pt, pw, pr, pg = point_budget_resample(xyz, pt_t, w, ring, tag, cfg.n_points)

        scan_start = float(pt[pw > 0].min()) if np.any(pw > 0) else t_scan - 0.1
        scan_end = float(max(pt.max(), t_scan))
        # The scan's time is the END of its window: VLP-16 bags stamp the
        # header at the sweep start with positive per-point offsets, and
        # the window end is right for start- and end-stamped bags alike.
        t_scan = scan_end
        if t_last_scan is None:
            t_last_scan = scan_start

        # IMU window (t_last_scan - margin, t_scan], zero-padded
        m = (imu_t > t_last_scan - 0.05) & (imu_t <= t_scan + 0.01)
        sel = np.nonzero(m)[0][-C.MAX_IMU_PREINT_LEN:]
        istk = np.zeros(C.MAX_IMU_PREINT_LEN)
        gyro = np.zeros((C.MAX_IMU_PREINT_LEN, 3))
        accel = np.zeros((C.MAX_IMU_PREINT_LEN, 3))
        for j, si in enumerate(sel):
            istk[j] = imu_t[si]
            gyro[j] = R_bi @ imu_gyro[si]
            accel[j] = R_bi @ (imu_accel[si] * cfg.imu_accel_scale)

        # closest odom, anchor-relative, z-variance floor
        if len(odom_t):
            oi = int(np.argmin(np.abs(odom_t - t_scan)))
            R_o = _rotvec_R(_quat_to_rotvec(odom_quat[oi]))
            odom_pose = np.concatenate([R_a.T @ (odom_pos[oi] - anchor[:3]), cdrless_rotvec(R_a.T @ R_o)])
            if k == 0 or prev_odom_idx is None:
                odom_rel = np.zeros(6)
                odom_rel_cov = 1e12 * np.eye(6)
            else:
                po = prev_odom_idx
                R_po = _rotvec_R(_quat_to_rotvec(odom_quat[po]))
                odom_rel = np.concatenate([R_po.T @ (odom_pos[oi] - odom_pos[po]), cdrless_rotvec(R_po.T @ R_o)])
                # Delta covariance: dead-reckoned odometry carries a
                # cumulative pose covariance, so the drift accrued between
                # the two stamps is the (clipped, diagonal) increment; the
                # white part appears at both ends and the stream's first
                # covariance is its clean estimate. A static-covariance bag
                # gives increment 0 + 2x the static covariance.
                cov_o = odom_pcov[oi].reshape(6, 6)
                cov_po = odom_pcov[po].reshape(6, 6)
                cov_w = odom_pcov[0].reshape(6, 6)
                inc = np.diag(np.maximum(np.diag(cov_o - cov_po), 0.0))
                odom_rel_cov = inc + 2.0 * cov_w
                odom_rel_cov[2, 2] = max(odom_rel_cov[2, 2], C.ODOM_Z_VARIANCE_PRIOR)
            prev_odom_idx = oi
            ocov = odom_pcov[oi].reshape(6, 6).copy()
            ocov[2, 2] = max(ocov[2, 2], C.ODOM_Z_VARIANCE_PRIOR)
            twist = odom_tw[oi].copy()
            tcov = odom_tcov[oi].reshape(6, 6)
        else:
            odom_pose = np.zeros(6)
            ocov = 1e12 * np.eye(6)
            twist = np.zeros(6)
            tcov = np.eye(6)
            odom_rel = np.zeros(6)
            odom_rel_cov = 1e12 * np.eye(6)

        # camera feature slice (zeros when no frame lands near this scan)
        camf = cam_stream.features_for(t_scan, p, pw) if cam_stream else None
        if camf is not None:
            cam = dict(cam_Lambdas=camf.Lambdas, cam_thetas=camf.thetas, cam_etas=camf.etas,
                       cam_weights=camf.weights, cam_colors=camf.colors, cam_valid=camf.valid)
        else:
            cam = dict(cam_Lambdas=np.zeros((C.N_FEAT, 3, 3)), cam_thetas=np.zeros((C.N_FEAT, 3)),
                       cam_etas=np.zeros((C.N_FEAT, C.VMF_N_LOBES, 3)), cam_weights=np.zeros(C.N_FEAT),
                       cam_colors=np.zeros((C.N_FEAT, 3)), cam_valid=np.zeros(C.N_FEAT, bool))

        batches.append(batch_from_numpy(dict(
            points=p, point_stamps=pt, point_weights=pw, point_ring=pr, point_tag=pg,
            imu_stamps=istk, imu_gyro=gyro, imu_accel=accel,
            odom_pose=odom_pose, odom_cov=ocov, odom_twist=twist, odom_twist_cov=tcov,
            odom_rel_pose=odom_rel, odom_rel_cov=odom_rel_cov,
            **cam,
            loop_pose=np.zeros(6), loop_cov=1e12 * np.eye(6), loop_weight=np.zeros(()),
            scan_start_time=np.asarray(scan_start), scan_end_time=np.asarray(scan_end),
            t_scan=np.asarray(t_scan), t_last_scan=np.asarray(t_last_scan),
            dt_sec=np.asarray(max(t_scan - t_last_scan, 1e-3)), scan_seq=np.asarray(k, np.int32),
        ), device=device))
        t_last_scan = t_scan

    return batches, None, None
