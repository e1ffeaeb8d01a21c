"""Synthesize a full-length, REAL-SCHEMA Kimera-like rosbag (counterpart of
the JAX package's frontend/bag_synth.py, on the port's synthetic world).

The reference's single test path replays the canonical Kimera-Multi bag
through the full stack (tools/run_and_evaluate_gc.sh:333). That bag is not
in the repository, so this module writes a rosbag2 sqlite .db3 with
the same message schemas, topic names, frames, clock skews, and rates as
`configs/gc_kimera.yaml` expects — raw CDR payloads, NOT ScanBatches — plus
a TUM ground-truth file, so `eval.run --bag --config configs/gc_kimera.yaml`
rehearses the ENTIRE production path: sqlite read, CDR decode, VLP-16
parsing, point budget, time alignment, extrinsic correction, anchor
smoothing, RGB-D pairing/decode, feature extraction, depth fusion.

Streams (all in their SENSOR frames; the frontend corrects into base):
  - PointCloud2 at scan_rate: VLP-16 layout (x,y,z,intensity f32; ring u16;
    time f32 relative to the header stamp), raycast from the shared
    synthetic room (frontend/synthetic.py);
  - Imu at imu_rate: gyro/accel with bias + noise in the IMU frame
    (Kimera: ~92 deg rotated vs base);
  - Odometry at odom_rate: drift-random-walk wheel odometry with honest
    growing covariance, quaternion orientation;
  - CompressedImage (JPEG, PIL) + 16UC1-mm depth Image + CameraInfo,
    rendered with the config's pinhole intrinsics in the optical frame.

Clock realism: stamps are epoch seconds at the canonical bag's t0, and each
stream is PRE-SKEWED by the inverse of the per-topic offset+drift alignment
profile, so the frontend's time-alignment stage actually has work to do and
recovers a consistent timeline.
"""

from __future__ import annotations

import dataclasses
import io
import sqlite3
from typing import Optional

import numpy as np

from gcslam_torch.frontend import cdr
from gcslam_torch.frontend.rosbag import BagConfig, _rotvec_R
from gcslam_torch.frontend.synthetic import (
    SyntheticConfig,
    _SENSOR_Z,
    _raycast_room,
    _vlp16_dirs,
    _yaw_R,
    build_trajectory,
)

# VLP-16 point layout (matches the Kimera bag's field set)
_POINT_STEP = 22
_FIELDS = [
    cdr.PointField("x", 0, 7, 1),
    cdr.PointField("y", 4, 7, 1),
    cdr.PointField("z", 8, 7, 1),
    cdr.PointField("intensity", 12, 7, 1),
    cdr.PointField("ring", 16, 4, 1),
    cdr.PointField("time", 18, 7, 1),
]


def _yaw_to_quat(yaw: float) -> np.ndarray:
    return np.array([0.0, 0.0, np.sin(yaw / 2.0), np.cos(yaw / 2.0)])


def _inverse_aligned(align, topic: str, t_true: float) -> float:
    """Emit stamp t_e with aligned(t_e) == t_true: the frontend's linear
    clock model is aligned_t = t + off + drift*(t - t0)."""
    if not align or topic not in align:
        return t_true
    a = align[topic]
    return (t_true - a.offset_sec + a.drift * a.t0_sec) / (1.0 + a.drift)


def write_synth_bag(
    db_path: str,
    cfg: SyntheticConfig,
    bag_cfg: BagConfig,
    gt_path: Optional[str] = None,
    odom_rate_hz: float = 20.0,
    cam_rate_hz: float = 10.0,
    cam_size: tuple = (640, 480),
    jpeg_quality: int = 85,
    t0_epoch: Optional[float] = None,
    progress: bool = False,
) -> dict:
    """Write the bag + TUM ground truth; returns a summary dict."""
    rng = np.random.default_rng(cfg.seed)
    traj = build_trajectory(cfg)
    scan_dt = 1.0 / cfg.scan_rate_hz
    duration = cfg.n_scans * scan_dt
    align = bag_cfg.alignment or {}
    if t0_epoch is None:
        # default to the alignment profile's reference epoch so drift terms
        # are evaluated where they were calibrated
        t0_epoch = next(iter(align.values())).t0_sec if align else 1665772901.387538

    # sensor mounts (sensor -> base)
    T_bl = np.asarray(bag_cfg.T_base_lidar, dtype=np.float64)
    T_bi = np.asarray(bag_cfg.T_base_imu, dtype=np.float64)
    T_bc = np.asarray(bag_cfg.T_base_camera, dtype=np.float64)
    R_bl, t_bl = _rotvec_R(T_bl[3:6]), T_bl[:3]
    R_bi = _rotvec_R(T_bi[3:6])
    R_bc, t_bc = _rotvec_R(T_bc[3:6]), T_bc[:3]
    # The room raycaster puts the floor at z=0; the rig rides _SENSOR_Z above
    # the base origin (same convention as synthetic.generate): ray origins
    # live in "room" coordinates = base world + [0, 0, _SENSOR_Z].
    rig_z = np.array([0.0, 0.0, _SENSOR_Z])

    conn = sqlite3.connect(db_path)
    conn.executescript(
        """
        CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,
                            serialization_format TEXT, offered_qos_profiles TEXT);
        CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,
                              timestamp INTEGER, data BLOB);
        """
    )
    topics = {
        1: (bag_cfg.lidar_topic or "/lidar/points", "sensor_msgs/msg/PointCloud2"),
        2: (bag_cfg.imu_topic or "/imu/data", "sensor_msgs/msg/Imu"),
        3: (bag_cfg.odom_topic or "/odom", "nav_msgs/msg/Odometry"),
    }
    if bag_cfg.with_camera:
        topics[4] = (bag_cfg.rgb_topic or "/camera/color/compressed",
                     "sensor_msgs/msg/CompressedImage")
        topics[5] = (bag_cfg.depth_topic or "/camera/depth",
                     "sensor_msgs/msg/Image")
        cam_info_topic = (topics[4][0].rsplit("/", 1)[0] + "/camera_info")
        topics[6] = (cam_info_topic, "sensor_msgs/msg/CameraInfo")
    conn.executemany(
        "INSERT INTO topics VALUES (?,?,?,?,?)",
        [(tid, name, typ, "cdr", "") for tid, (name, typ) in topics.items()],
    )
    rows = []

    def emit(tid: int, t_emit: float, payload: bytes):
        rows.append((tid, int(round(t_emit * 1e9)), payload))

    g_w = np.array([0.0, 0.0, -9.81])
    gyro_bias = np.array(cfg.gyro_bias)
    accel_bias = np.array(cfg.accel_bias)

    # ---- IMU stream (continuous, sensor frame) ---------------------------
    imu_topic = topics[2][0]
    imu_t = np.arange(1.0 / cfg.imu_rate_hz, duration + 1e-9, 1.0 / cfg.imu_rate_hz)
    _, yaw_i, _, wz_i, a_world = traj(imu_t)
    R_i = _yaw_R(yaw_i)
    n_imu = len(imu_t)
    omega_body = np.stack(
        [np.zeros(n_imu), np.zeros(n_imu), np.broadcast_to(wz_i, (n_imu,))], -1
    )
    f_body = np.einsum("mji,mj->mi", R_i, a_world - g_w[None, :])
    gyro_s = omega_body @ R_bi + gyro_bias + rng.normal(0, cfg.gyro_noise_std, (n_imu, 3))
    accel_s = (f_body @ R_bi + accel_bias
               + rng.normal(0, cfg.accel_noise_std, (n_imu, 3))) / bag_cfg.imu_accel_scale
    for i in range(n_imu):
        t_e = _inverse_aligned(align, imu_topic, imu_t[i] + t0_epoch)
        msg = cdr.Imu(
            header=cdr.Header(t_e, "imu"),
            orientation=np.array([0, 0, 0, 1.0]),
            angular_velocity=gyro_s[i],
            linear_acceleration=accel_s[i],
        )
        emit(2, t_e, cdr.serialize_imu(msg))

    # ---- Odometry stream (drift random walk, honest growing covariance) --
    odom_topic = topics[3][0]
    odom_t = np.arange(0.0, duration + 1e-9, 1.0 / odom_rate_hz)
    pos_o, yaw_o, v_o, wz_o, _ = traj(odom_t)
    drift = np.zeros(3)
    dr_pos, dr_yaw = np.zeros(3), 0.0
    cum_dist = 0.0
    prev_pos = pos_o[0]
    prev_yaw = float(yaw_o[0])
    for i, t in enumerate(odom_t):
        pos, yaw = pos_o[i], float(yaw_o[i])
        step = float(np.linalg.norm(pos - prev_pos))
        ss = np.sqrt(max(step, 0.0))
        cum_dist += step
        if cfg.odom_model == "integrated":
            dp_true = _yaw_R(np.asarray(prev_yaw)).T @ (pos - prev_pos)
            dyaw_true = yaw - prev_yaw
            dp_meas = dp_true + np.array([1.0, 1.0, 0.0]) * rng.normal(
                0, cfg.odom_drift_pos_per_m * ss, 3)
            dyaw_meas = dyaw_true + rng.normal(0, cfg.odom_drift_yaw_per_m * ss)
            if i == 0:
                dr_pos, dr_yaw = pos.copy(), yaw
            else:
                dr_pos = dr_pos + _yaw_R(np.asarray(dr_yaw)) @ dp_meas
                dr_yaw = dr_yaw + dyaw_meas
            opos = dr_pos + rng.normal(0, cfg.odom_pos_noise_std / 10, 3)
            oyaw = dr_yaw + rng.normal(0, cfg.odom_yaw_noise_std / 10)
        else:
            drift[:2] += rng.normal(0, cfg.odom_drift_pos_per_m * ss, 2)
            drift[2] += rng.normal(0, cfg.odom_drift_yaw_per_m * ss)
            opos = pos + np.array([drift[0], drift[1], 0.0]) + rng.normal(
                0, cfg.odom_pos_noise_std, 3)
            oyaw = yaw + drift[2] + rng.normal(0, cfg.odom_yaw_noise_std)
        prev_pos, prev_yaw = pos.copy(), yaw
        dp_cum = cfg.odom_drift_pos_per_m**2 * cum_dist
        dy_cum = cfg.odom_drift_yaw_per_m**2 * cum_dist
        if cfg.odom_model == "integrated":
            dp_cum += cfg.odom_drift_yaw_per_m**2 * cum_dist**3 / 3.0
        pose_cov = np.diag(
            [cfg.odom_pos_noise_std**2 + dp_cum] * 3
            + [cfg.odom_yaw_noise_std**2 + dy_cum] * 3
        ).reshape(-1)
        v_body = _yaw_R(np.asarray(yaw)).T @ v_o[i] + rng.normal(
            0, cfg.odom_vel_noise_std, 3)
        t_e = _inverse_aligned(align, odom_topic, t + t0_epoch)
        msg = cdr.Odometry(
            header=cdr.Header(t_e, "odom"),
            child_frame_id="base",
            position=opos,
            orientation=_yaw_to_quat(oyaw),
            pose_cov=pose_cov,
            twist_linear=v_body,
            twist_angular=np.array([0.0, 0.0, wz_o[i] + rng.normal(0, 1e-3)]),
            twist_cov=np.diag([cfg.odom_vel_noise_std**2] * 3 + [1e-6] * 3).reshape(-1),
        )
        emit(3, t_e, cdr.serialize_odometry(msg))

    # ---- LiDAR scans (VLP-16 layout, sensor frame, per-point rel time) ----
    lidar_topic = topics[1][0]
    gt_rows = []
    for k in range(cfg.n_scans):
        scan_start = k * scan_dt
        scan_end = scan_start + scan_dt
        pt_rel = np.sort(rng.uniform(0.0, scan_dt, cfg.n_points))
        pt_times = scan_start + pt_rel
        pos_t, yaw_t, _, _, _ = traj(pt_times)
        R_t = _yaw_R(yaw_t)
        pos_e, yaw_e, _, _, _ = traj(scan_end)
        dirs_body = _vlp16_dirs(rng, cfg.n_points, yaw_e)
        ring = (np.arange(cfg.n_points) % 16).astype("<u2")
        dirs_world = np.einsum("mij,mj->mi", R_t, dirs_body)
        origins = pos_t + rig_z[None, :] + np.einsum("mij,j->mi", R_t, t_bl)
        world_pts, hit = _raycast_room(origins, dirs_world, cfg.max_range)
        # sensor-frame returns + range noise in the LiDAR frame
        R_s = np.einsum("mij,jk->mik", R_t, R_bl)  # (m, 3, 3) lidar->world
        p_lidar = np.einsum("mji,mj->mi", R_s, world_pts - origins)
        p_lidar = p_lidar + rng.normal(0, cfg.lidar_noise_std, p_lidar.shape)
        p_lidar = np.where(hit[:, None], p_lidar, 0.0)

        raw = np.zeros((cfg.n_points, _POINT_STEP), dtype=np.uint8)
        raw[:, 0:12] = p_lidar.astype("<f4").view(np.uint8).reshape(cfg.n_points, 12)
        inten = (100.0 * hit).astype("<f4")
        raw[:, 12:16] = inten.view(np.uint8).reshape(cfg.n_points, 4)
        raw[:, 16:18] = ring.view(np.uint8).reshape(cfg.n_points, 2)
        raw[:, 18:22] = pt_rel.astype("<f4").view(np.uint8).reshape(cfg.n_points, 4)
        t_e = _inverse_aligned(align, lidar_topic, scan_start + t0_epoch)
        msg = cdr.PointCloud2(
            header=cdr.Header(t_e, "lidar"),
            height=1, width=cfg.n_points, fields=_FIELDS, is_bigendian=False,
            point_step=_POINT_STEP, row_step=_POINT_STEP * cfg.n_points,
            data=raw.tobytes(), is_dense=True,
        )
        emit(1, t_e, cdr.serialize_pointcloud2(msg))
        # GT row: the pose sampled at the scan's END carries the END stamp
        # (the frontend's scan time, rosbag.load_bag).
        q = _yaw_to_quat(float(yaw_e))
        gt_rows.append((scan_end + t0_epoch, *pos_e, *q))
        if progress and k % 40 == 0:
            print(f"lidar scan {k}/{cfg.n_scans}", flush=True)

    # ---- RGB-D camera (JPEG rgb + 16UC1 depth + CameraInfo) --------------
    if bag_cfg.with_camera:
        from PIL import Image as PILImage

        fx, fy, cx, cy = bag_cfg.camera_intrinsics
        W, H = cam_size
        rgb_topic, depth_topic = topics[4][0], topics[5][0]
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        d_cam = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=np.float64)], -1
        )
        d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
        d_cam_flat = d_cam.reshape(-1, 3)
        cam_t = np.arange(0.05, duration + 1e-9, 1.0 / cam_rate_hz)
        for j, t in enumerate(cam_t):
            pos, yaw, _, _, _ = traj(t)
            R_wb = _yaw_R(np.asarray(yaw))
            R_wc = R_wb @ R_bc
            origin = pos + rig_z + R_wb @ t_bc
            d_world = d_cam_flat @ R_wc.T
            origins = np.broadcast_to(origin, d_world.shape).copy()
            pts, hit = _raycast_room(origins, d_world, cfg.max_range)
            depth_m = ((pts - origin) @ R_wc)[:, 2]
            depth_m = np.where(hit, depth_m, 0.0).reshape(H, W)
            tex = ((np.floor(pts[:, 0] * 2) + np.floor(pts[:, 1] * 2)
                    + np.floor(pts[:, 2] * 2)) % 2)
            gray = (0.3 + 0.5 * tex
                    + 0.2 * np.sin(pts[:, 0]) * np.cos(pts[:, 1])).reshape(H, W)
            rgb = np.stack(
                [gray, 0.5 + 0.3 * np.cos(pts[:, 2] * 3).reshape(H, W), 1.0 - gray], -1
            )
            rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            buf = io.BytesIO()
            PILImage.fromarray(rgb8).save(buf, format="JPEG", quality=jpeg_quality)
            t_rgb = _inverse_aligned(align, rgb_topic, t + t0_epoch)
            emit(4, t_rgb, cdr.serialize_compressed_image(cdr.CompressedImage(
                header=cdr.Header(t_rgb, "camera"), format="jpeg",
                data=buf.getvalue(),
            )))
            depth_mm = np.clip(depth_m * 1000.0, 0, 65535).astype("<u2")
            t_d = _inverse_aligned(align, depth_topic, t + t0_epoch)
            emit(5, t_d, cdr.serialize_image(cdr.Image(
                header=cdr.Header(t_d, "camera"), height=H, width=W,
                encoding="16UC1", is_bigendian=False, step=W * 2,
                data=depth_mm.tobytes(),
            )))
            if j == 0:
                K = np.array([fx, 0, cx, 0, fy, cy, 0, 0, 1.0])
                emit(6, t_rgb, cdr.serialize_camera_info(cdr.CameraInfo(
                    header=cdr.Header(t_rgb, "camera"), height=H, width=W,
                    distortion_model="plumb_bob", d=np.zeros(5), k=K,
                    r=np.eye(3).reshape(-1),
                    p=np.array([fx, 0, cx, 0, 0, fy, cy, 0, 0, 0, 1, 0]),
                )))
            if progress and j % 40 == 0:
                print(f"camera frame {j}/{len(cam_t)}", flush=True)

    rows.sort(key=lambda r: r[1])
    conn.executemany(
        "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)", rows
    )
    conn.commit()
    conn.close()

    if gt_path is not None:
        with open(gt_path, "w") as f:
            f.write("# t x y z qx qy qz qw\n")
            for row in gt_rows:
                f.write(" ".join(f"{x:.9f}" for x in row) + "\n")

    return {
        "bag": db_path,
        "gt": gt_path,
        "n_scans": cfg.n_scans,
        "n_imu": n_imu,
        "n_odom": len(odom_t),
        "n_cam_frames": int(len(cam_t)) if bag_cfg.with_camera else 0,
        "duration_s": duration,
        "t0_epoch": t0_epoch,
        "n_messages": len(rows),
    }
