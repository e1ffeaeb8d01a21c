"""Synthetic world + sensor-rig generator (counterpart of
the JAX package's frontend/synthetic.py, LiDAR + IMU + odometry).

A planar robot drives a smooth arc through a room of walls and pillars,
emitting VLP-16-like LiDAR scans with real per-point skew, 200 Hz IMU
(specific force + gyro with bias and noise) and drifting wheel odometry;
ground truth is returned for ATE scoring. With `with_camera` it also
raycasts a small pinhole RGB-D frame per scan and runs the visual frontend
(frontend/camera.py) on it to fill the batch's camera slice. All randomness
comes from one numpy `default_rng(seed)` in the same order as the JAX
package's generator, so both produce the same LiDAR, IMU and odometry
streams bit for bit. Batches, and the camera frontend, live on `device`
(default: the CUDA card).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.frontend import camera as cam_mod
from benchmark.reference.plain.models.scan_io import ScanBatch, batch_from_numpy, range_weights
from benchmark.reference.plain.utils.device import resolve_device


def _rotvec_R(rv) -> np.ndarray:
    """Rodrigues rotation of a rotation vector (numpy)."""
    rv = np.asarray(rv, dtype=np.float64)
    th = np.linalg.norm(rv)
    if th < 1e-12:
        return np.eye(3)
    k = rv / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_scans: int = 160
    scan_rate_hz: float = 10.0
    imu_rate_hz: float = 200.0
    n_points: int = C.N_POINTS_CAP
    speed_mps: float = 0.5
    turn_rate: float = 0.1  # rad/s yaw rate
    # "ramp": raised-cosine speed/yaw ramp (default, open path);
    # "circuit": closed circle of radius circuit_radius_m — the robot
    # RETURNS TO START when the path length exceeds 2*pi*R (the revisit
    # geometry loop closures exist for; size n_scans accordingly).
    trajectory: str = "ramp"
    circuit_radius_m: float = 2.5
    # Clock origin for all emitted stamps (epoch seconds). Real bags carry
    # ~1.7e9 s stamps; setting this exercises the TIME_DTYPE (f64 stamps /
    # f32-safe deltas) contract.
    t0: float = 0.0
    seed: int = 0
    # Sensor noise (vibration-level accel noise typical of a ground robot;
    # the measurement-IW states adapt to whatever these are)
    gyro_noise_std: float = 2e-3  # rad/s
    accel_noise_std: float = 0.2  # m/s^2
    gyro_bias: Tuple[float, float, float] = (2e-3, -1e-3, 5e-4)
    accel_bias: Tuple[float, float, float] = (1e-2, -5e-3, 2e-2)
    lidar_noise_std: float = 0.01  # m
    odom_pos_noise_std: float = 0.02  # m
    odom_yaw_noise_std: float = 0.005  # rad
    odom_vel_noise_std: float = 0.02  # m/s
    # Wheel-odometry DRIFT (random walk), the error mode SLAM exists to fix:
    # per meter of travel the odom frame slips and rotates.
    odom_drift_pos_per_m: float = 0.02  # m of drift per m traveled
    odom_drift_yaw_per_m: float = 0.01  # rad of drift per m traveled
    # Odometry error model:
    #  - "additive": drift random walk added to the TRUE pose — position and
    #    yaw errors stay independent. Simple, but unrealistically kind to
    #    raw odometry: a robot whose heading is 18 deg wrong still reports
    #    near-perfect positions.
    #  - "integrated": dead-reckoned wheel odometry (what real encoders do,
    #    reference tools/dead_reckon_odom_dump.py): each scan's measured
    #    body-frame step is composed onto the PREVIOUS odom pose, so heading
    #    error bends the whole trajectory from there on (the "banana").
    #    Position error grows ~ sigma_yaw * path; SLAM must beat this.
    odom_model: str = "additive"
    max_range: float = 25.0
    # Non-identity sensor extrinsics (the Kimera rig regime: T_base_imu
    # carries a ~92 deg rotation, configs/gc_kimera.yaml). Sensor data is
    # GENERATED in the sensor frame and then corrected into base exactly the
    # way the bag frontend does (rosbag.load_bag) — a round-trip exercise of
    # the rotvec/transform conventions that identity extrinsics never test.
    T_base_lidar: Tuple[float, ...] = (0.0,) * 6  # [t(3), rotvec(3)]
    T_base_imu: Tuple[float, ...] = (0.0,) * 6
    # RGB-D camera: raycast a small pinhole image per scan and run the
    # visual frontend (Harris + depth fusion) to fill the camera slice.
    with_camera: bool = False
    cam_w: int = 160
    cam_h: int = 120
    cam_fx: float = 120.0


def _yaw_R(yaw: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    zero = np.zeros_like(yaw)
    one = np.ones_like(yaw)
    return np.stack(
        [
            np.stack([c, -s, zero], -1),
            np.stack([s, c, zero], -1),
            np.stack([zero, zero, one], -1),
        ],
        -2,
    )


_PILLARS = np.array([[5, 5], [-5, 5], [5, -5], [-5, -5], [8, 0], [-8, 0]], dtype=np.float64)
_PILLAR_R = 0.4
_PILLAR_H = 2.5
_ROOM = 15.0
_WALL_H = 3.0
_SENSOR_Z = 0.5  # sensor height above the base origin


def _raycast_room(origins: np.ndarray, dirs: np.ndarray, max_range: float) -> Tuple[np.ndarray, np.ndarray]:
    """Raycast a synthetic room (ground plane, 4 walls, 6 pillars).

    origins/dirs: (N, 3) world frame. Returns (hit points (N, 3), hit mask).
    Real-scanner geometry: point density falls off with range like a VLP-16's.
    """
    N = origins.shape[0]
    t_best = np.full(N, np.inf)

    def consider(t, ok):
        np.copyto(t_best, np.where(ok & (t > 0.05) & (t < t_best), t, t_best))

    # ground z=0
    dz = dirs[:, 2]
    t = np.where(dz < -1e-9, -origins[:, 2] / np.where(dz == 0, 1.0, dz), np.inf)
    consider(t, np.isfinite(t))
    # walls
    for axis, val in [(0, _ROOM), (0, -_ROOM), (1, _ROOM), (1, -_ROOM)]:
        d = dirs[:, axis]
        t = np.where(np.abs(d) > 1e-9, (val - origins[:, axis]) / np.where(d == 0, 1.0, d), np.inf)
        p = origins + t[:, None] * dirs
        other = 1 - axis
        ok = np.isfinite(t) & (np.abs(p[:, other]) <= _ROOM) & (p[:, 2] >= 0) & (p[:, 2] <= _WALL_H)
        consider(t, ok)
    # pillars (infinite cylinder clipped in z)
    for cx, cy in _PILLARS:
        ox = origins[:, 0] - cx
        oy = origins[:, 1] - cy
        dx, dy = dirs[:, 0], dirs[:, 1]
        a = dx * dx + dy * dy
        b = 2 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - _PILLAR_R**2
        disc = b * b - 4 * a * c
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / np.where(a == 0, 1.0, 2 * a)
        p = origins + t[:, None] * dirs
        ok = ok & (t > 0.05) & (p[:, 2] >= 0) & (p[:, 2] <= _PILLAR_H)
        consider(t, ok)

    hit = np.isfinite(t_best) & (t_best <= max_range)
    t_best = np.where(hit, t_best, max_range)
    return origins + t_best[:, None] * dirs, hit


def _vlp16_dirs(rng: np.random.Generator, n: int, yaw0: np.ndarray) -> np.ndarray:
    """VLP-16-like ray directions in BODY frame: 16 elevation rings from -15
    to +15 deg, azimuth sweeping the full circle across the scan."""
    n_rings = 16
    elev = np.deg2rad(np.linspace(-15.0, 15.0, n_rings))
    ring = np.arange(n) % n_rings
    az = (np.arange(n) / n) * 2 * np.pi + rng.uniform(0, 2 * np.pi)
    el = elev[ring]
    ce, se = np.cos(el), np.sin(el)
    return np.stack([ce * np.cos(az), ce * np.sin(az), se], -1)


# Camera mounted looking along +x of the base, z-up -> standard pinhole
# axes (z forward, x right, y down).
R_BASE_CAM = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
_CAM_OFFSET = np.array([0.15, 0.0, _SENSOR_Z])  # camera origin in the base frame


def _rotvec_of(R) -> np.ndarray:
    tr = np.trace(R)
    cos = np.clip(0.5 * (tr - 1), -1, 1)
    vex = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin = np.linalg.norm(vex)
    theta = np.arctan2(sin, cos)
    return vex * (theta / sin if sin > 1e-9 else 1.0)


T_BASE_CAM = np.concatenate([_CAM_OFFSET, _rotvec_of(R_BASE_CAM)])  # [t(3), rotvec(3)]


def _render_rgbd(pos, yaw, cfg):
    """Raycast a pinhole RGB-D frame of the room from the robot pose."""
    W, H = cfg.cam_w, cfg.cam_h
    fx = fy = cfg.cam_fx
    cx, cy = W / 2.0, H / 2.0
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=np.float64)], -1)
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    R_wb = _yaw_R(np.asarray(yaw))
    R_wc = R_wb @ R_BASE_CAM
    d_world = d_cam.reshape(-1, 3) @ R_wc.T
    origin = pos + R_wb @ _CAM_OFFSET
    origins = np.broadcast_to(origin, d_world.shape).copy()
    pts, hit = _raycast_room(origins, d_world, cfg.max_range)
    # depth = z in the camera frame
    depth = ((pts - origin) @ R_wc)[:, 2]
    depth = np.where(hit, depth, 0.0).reshape(H, W)
    # procedural world texture: 0.5 m checker + smooth gradients
    tex = ((np.floor(pts[:, 0] * 2) + np.floor(pts[:, 1] * 2) + np.floor(pts[:, 2] * 2)) % 2)
    gray = (0.3 + 0.5 * tex + 0.2 * np.sin(pts[:, 0]) * np.cos(pts[:, 1])).reshape(H, W)
    rgb = np.stack([gray, 0.5 + 0.3 * np.cos(pts[:, 2] * 3).reshape(H, W), 1.0 - gray], -1)
    return gray, depth, np.clip(rgb, 0, 1), R_wc, origin


def _camera_slice(cfg, pos, yaw, p_body, weights, device, native: bool) -> dict:
    """The batch's camera fields for one scan: render, extract features with
    the LiDAR points as depth evidence, move to the base frame. `native`:
    corners, robust depth and plane fit in the C++ stage on the host, the
    lift on `device` (the JAX generator's route when its library is built);
    else every stage in torch on `device`."""
    gray, depth_img, rgb_img, R_wc, cam_origin = _render_rgbd(pos, yaw, cfg)
    intr = cam_mod.PinholeIntrinsics(fx=cfg.cam_fx, fy=cfg.cam_fx, cx=cfg.cam_w / 2.0, cy=cfg.cam_h / 2.0)
    # LiDAR points (body) -> camera frame for the Route A/B depth fusion
    lidar_world = p_body @ _yaw_R(np.asarray(yaw)).T + pos[None, :]
    lidar_cam = (lidar_world - cam_origin[None, :]) @ R_wc

    def t(x):
        return torch.as_tensor(x, device=device)

    if native:
        feats = cam_mod.extract_camera_features_native(
            gray, depth_img, rgb_img, intr, lidar_cam, weights, n_feat=C.N_FEAT, device=device)
    else:
        feats = cam_mod.extract_camera_features(
            t(gray), t(depth_img), t(rgb_img), intr, t(lidar_cam), t(weights), n_feat=C.N_FEAT)
    feats = cam_mod.features_to_base_frame(feats, T_BASE_CAM)
    return dict(cam_Lambdas=feats.Lambdas, cam_thetas=feats.thetas, cam_etas=feats.etas,
                cam_weights=feats.weights, cam_colors=feats.colors, cam_valid=feats.valid)


class SyntheticRun(NamedTuple):
    batches: List[ScanBatch]
    gt_poses: np.ndarray  # (n_scans, 7) [t, x, y, z, yaw... as 6D pose]
    gt_times: np.ndarray  # (n_scans,)


def build_trajectory(cfg: SyntheticConfig):
    """Ground-truth trajectory sampler shared by generate() and the bag
    synthesizer (frontend/bag_synth.py) so ScanBatches and synthesized bags
    describe the SAME world. Robot starts AT REST, speed ramps with a
    raised-cosine profile over t_ramp, yaw rate ramps identically (rigs in
    the canonical bags start stationary; an instant-velocity start would
    fight the filter's at-rest prior through the IMU preint factor).

    Returns traj(t) -> (pos(…,3), yaw, v_world(…,3), omega_z, a_world(…,3)).
    """
    imu_dt = 1.0 / cfg.imu_rate_hz
    duration = cfg.n_scans / cfg.scan_rate_hz
    t_ramp = min(2.0, 0.25 * duration)
    grid = np.arange(0.0, duration + 2 * imu_dt, imu_dt / 4.0)

    def _speed(t):
        s = np.clip(t / t_ramp, 0.0, 1.0)
        return cfg.speed_mps * 0.5 * (1.0 - np.cos(np.pi * s))

    if cfg.trajectory == "circuit":
        # Closed circle: yaw rate tracks speed/R so the path curvature is
        # constant at 1/R through the ramp and cruise.
        def _yaw_rate(t):
            return _speed(t) / cfg.circuit_radius_m

    else:

        def _yaw_rate(t):
            s = np.clip(t / t_ramp, 0.0, 1.0)
            return cfg.turn_rate * 0.5 * (1.0 - np.cos(np.pi * s))

    yaw_grid = np.concatenate([[0.0], np.cumsum(0.5 * (_yaw_rate(grid[1:]) + _yaw_rate(grid[:-1])) * np.diff(grid))])
    speed_grid = _speed(grid)
    vx = speed_grid * np.cos(yaw_grid)
    vy = speed_grid * np.sin(yaw_grid)
    x_grid = np.concatenate([[0.0], np.cumsum(0.5 * (vx[1:] + vx[:-1]) * np.diff(grid))])
    y_grid = np.concatenate([[0.0], np.cumsum(0.5 * (vy[1:] + vy[:-1]) * np.diff(grid))])
    ax_grid = np.gradient(vx, grid)
    ay_grid = np.gradient(vy, grid)

    def traj(t):
        """Interpolated ground truth: (pos(…,3), yaw, v_world(…,3), omega_z, a_world(…,3))."""
        t = np.asarray(t, dtype=np.float64)
        x = np.interp(t, grid, x_grid)
        y = np.interp(t, grid, y_grid)
        yaw = np.interp(t, grid, yaw_grid)
        vxi = np.interp(t, grid, vx)
        vyi = np.interp(t, grid, vy)
        wz = np.interp(t, grid, _yaw_rate(grid))
        axi = np.interp(t, grid, ax_grid)
        ayi = np.interp(t, grid, ay_grid)
        z = np.zeros_like(t)
        pos = np.stack([x, y, z], -1)
        v_world = np.stack([vxi, vyi, z], -1)
        a_world = np.stack([axi, ayi, z], -1)
        return pos, yaw, v_world, wz, a_world

    return traj


def generate(cfg: SyntheticConfig = SyntheticConfig(), device=None, native=None) -> SyntheticRun:
    """The synthetic replay: one ScanBatch per scan on `device` (default:
    the CUDA card), ground-truth poses and stamps. With the camera on,
    `native` picks the visual frontend's route: True the C++ corner stage
    (frontend/native.py), False the pure torch route, None the native route
    unless GCSLAM_NO_NATIVE=1."""
    device = resolve_device(device)
    if cfg.with_camera:
        from benchmark.reference.plain.frontend.native import resolve_native

        native = resolve_native(native, "the synthetic camera frontend")
    rng = np.random.default_rng(cfg.seed)
    scan_dt = 1.0 / cfg.scan_rate_hz
    imu_dt = 1.0 / cfg.imu_rate_hz

    traj = build_trajectory(cfg)

    g_w = np.array(C.GRAVITY_W)
    gyro_bias = np.array(cfg.gyro_bias)
    accel_bias = np.array(cfg.accel_bias)

    # Extrinsics: generate in the SENSOR frame, correct into base with the
    # frontend's exact convention (rosbag.load_bag:414-454 — p_base =
    # R_bl p_lidar + t_bl; omega_base = R_bi omega_imu). With identity
    # extrinsics both steps are no-ops.
    T_bl = np.asarray(cfg.T_base_lidar, dtype=np.float64)
    T_bi = np.asarray(cfg.T_base_imu, dtype=np.float64)
    R_bl, t_bl = _rotvec_R(T_bl[3:6]), T_bl[:3]
    R_bi = _rotvec_R(T_bi[3:6])

    # World model (fixed point cloud on surfaces; resampled per scan)
    batches: List[ScanBatch] = []
    gt_poses = np.zeros((cfg.n_scans, 6))
    gt_times = np.zeros(cfg.n_scans)

    t_last_scan = 0.0
    odom_drift = np.zeros(3)  # [dx, dy, dyaw] accumulated random walk
    prev_pos = np.zeros(3)
    prev_yaw_true = 0.0
    odom_dr_pos, odom_dr_yaw = np.zeros(3), 0.0  # dead-reckoned odom state
    cum_dist = 0.0
    for k in range(cfg.n_scans):
        t_scan = (k + 1) * scan_dt  # scan header stamp = window end
        scan_start = t_scan - scan_dt
        scan_end = t_scan

        # --- ground truth at scan end
        pos, yaw, v_world, wz, _ = traj(t_scan)
        gt_poses[k] = np.concatenate([pos, [0.0, 0.0, yaw]])
        gt_times[k] = t_scan + cfg.t0

        # --- IMU window (t_last_scan, t_scan]; includes deskew coverage
        stamps = np.arange(np.floor(scan_start / imu_dt) * imu_dt, scan_end + 1e-9, imu_dt)
        stamps = stamps[(stamps > 1e-9)]
        n_imu = min(len(stamps), C.MAX_IMU_PREINT_LEN)
        stamps = stamps[-n_imu:]
        _, yaw_i, _, wz_i, a_world = traj(stamps)
        R_i = _yaw_R(yaw_i)  # (M, 3, 3)
        omega_body = np.stack([np.zeros(n_imu), np.zeros(n_imu), np.broadcast_to(wz_i, (n_imu,))], -1)
        # specific force f_body = R^T (a_world - g)
        f_body = np.einsum("mji,mj->mi", R_i, a_world - g_w[None, :])
        # sensor-frame measurement (bias+noise live in the IMU frame), then
        # the frontend's base-frame correction (rosbag.load_bag:453-454)
        gyro_s = omega_body @ R_bi + gyro_bias + rng.normal(0, cfg.gyro_noise_std, (n_imu, 3))
        accel_s = f_body @ R_bi + accel_bias + rng.normal(0, cfg.accel_noise_std, (n_imu, 3))
        gyro = gyro_s @ R_bi.T
        accel = accel_s @ R_bi.T

        imu_stamps = np.zeros(C.MAX_IMU_PREINT_LEN)
        imu_gyro = np.zeros((C.MAX_IMU_PREINT_LEN, 3))
        imu_accel = np.zeros((C.MAX_IMU_PREINT_LEN, 3))
        imu_stamps[:n_imu] = stamps
        imu_gyro[:n_imu] = gyro
        imu_accel[:n_imu] = accel

        # --- LiDAR scan: raycast the room with real per-point skew
        pt_times = np.sort(rng.uniform(scan_start, scan_end, cfg.n_points))
        pos_t, yaw_t, _, _, _ = traj(pt_times)
        R_t = _yaw_R(yaw_t)
        dirs_body = _vlp16_dirs(rng, cfg.n_points, yaw)
        dirs_world = np.einsum("mij,mj->mi", R_t, dirs_body)
        origins = pos_t + np.array([0.0, 0.0, _SENSOR_Z])[None, :]
        world_pts, hit = _raycast_room(origins, dirs_world, cfg.max_range)
        p_body = np.einsum("mji,mj->mi", R_t, world_pts - pos_t)
        dist = np.linalg.norm(p_body - np.array([0.0, 0.0, _SENSOR_Z])[None, :], axis=1)
        # sensor-frame returns (noise is range noise in the LiDAR frame),
        # then the frontend's base-frame transform (rosbag.load_bag:435)
        p_lidar = (p_body - t_bl[None, :]) @ R_bl
        p_lidar = p_lidar + rng.normal(0, cfg.lidar_noise_std, p_lidar.shape)
        p_body = p_lidar @ R_bl.T + t_bl[None, :]
        weights = range_weights(dist) * hit

        # --- odometry (drifting + noisy pose, twist in body frame)
        dist_step = float(np.linalg.norm(pos - prev_pos))
        step_scale = np.sqrt(max(dist_step, 0.0))
        if cfg.odom_model == "integrated":
            # Dead-reckoned wheel odometry: compose the MEASURED body-frame
            # step onto the previous odom pose. Heading error bends every
            # subsequent position — the real encoder error mode.
            dp_true = _yaw_R(np.asarray(prev_yaw_true)).T @ (pos - prev_pos)
            dyaw_true = yaw - prev_yaw_true
            dp_meas = dp_true + np.array([1.0, 1.0, 0.0]) * rng.normal(
                0, cfg.odom_drift_pos_per_m * step_scale, 3)
            dyaw_meas = dyaw_true + rng.normal(
                0, cfg.odom_drift_yaw_per_m * step_scale)
            if k == 0:
                odom_dr_pos, odom_dr_yaw = pos.copy(), float(yaw)
            else:
                odom_dr_pos = odom_dr_pos + _yaw_R(np.asarray(odom_dr_yaw)) @ dp_meas
                odom_dr_yaw = odom_dr_yaw + dyaw_meas
            odom_pos = odom_dr_pos + rng.normal(0, cfg.odom_pos_noise_std / 10, 3)
            odom_yaw = odom_dr_yaw + rng.normal(0, cfg.odom_yaw_noise_std / 10)
        else:
            odom_drift[:2] += rng.normal(0, cfg.odom_drift_pos_per_m * step_scale, 2)
            odom_drift[2] += rng.normal(0, cfg.odom_drift_yaw_per_m * step_scale)
            odom_pos = pos + np.array([odom_drift[0], odom_drift[1], 0.0]) + rng.normal(
                0, cfg.odom_pos_noise_std, 3
            )
            odom_yaw = yaw + odom_drift[2] + rng.normal(0, cfg.odom_yaw_noise_std)
        prev_yaw_true = float(yaw)
        prev_pos = pos.copy()
        odom_pose_now = np.concatenate([odom_pos, [0.0, 0.0, odom_yaw]])
        if k == 0:
            odom_rel = np.zeros(6)
            odom_rel_cov = 1e12 * np.eye(6)
            prev_odom_pose = odom_pose_now
        else:
            Rp = _yaw_R(np.asarray(prev_odom_pose[5]))
            dp = Rp.T @ (odom_pose_now[:3] - prev_odom_pose[:3])
            dyaw = odom_pose_now[5] - prev_odom_pose[5]
            odom_rel = np.concatenate([dp, [0.0, 0.0, dyaw]])
            # Honest delta noise: white pose noise (x2, both endpoints) plus
            # the slip/drift random walk accrued over this step's distance.
            drift_p_var = cfg.odom_drift_pos_per_m**2 * dist_step
            drift_y_var = cfg.odom_drift_yaw_per_m**2 * dist_step
            odom_rel_cov = np.diag(
                [2 * cfg.odom_pos_noise_std**2 + drift_p_var] * 3
                + [2 * cfg.odom_yaw_noise_std**2 + drift_y_var] * 3
            )
            odom_rel_cov[2, 2] = C.ODOM_Z_VARIANCE_PRIOR
            prev_odom_pose = odom_pose_now
        odom_pose = np.concatenate([odom_pos, [0.0, 0.0, odom_yaw]])
        # Honest absolute covariance: the drift is a random walk per meter, so
        # the pose error variance GROWS with distance traveled. A fixed
        # covariance (the reference consumes whatever the bag claims,
        # backend_node.py) makes the filter cling to stale odom yaw forever
        # and caps SLAM at odom accuracy.
        cum_dist += dist_step
        drift_p_cum = cfg.odom_drift_pos_per_m**2 * cum_dist
        drift_y_cum = cfg.odom_drift_yaw_per_m**2 * cum_dist
        if cfg.odom_model == "integrated":
            # heading random walk leaks into position ~ sigma_yaw(s)*path:
            # Var[p] ~ sigma_yaw_per_m^2 * integral_0^S (S-u)^2 du = y_var*S^3/3
            drift_p_cum += cfg.odom_drift_yaw_per_m**2 * cum_dist**3 / 3.0
        odom_cov = np.diag(
            [cfg.odom_pos_noise_std**2 + drift_p_cum] * 3
            + [cfg.odom_yaw_noise_std**2 + drift_y_cum] * 3
        )
        odom_cov[2, 2] = C.ODOM_Z_VARIANCE_PRIOR  # z-variance floor
        v_body = _yaw_R(np.asarray(yaw)).T @ v_world + rng.normal(0, cfg.odom_vel_noise_std, 3)
        odom_twist = np.concatenate([v_body, [0.0, 0.0, wz + rng.normal(0, 1e-3)]])
        odom_twist_cov = np.diag([cfg.odom_vel_noise_std**2] * 3 + [1e-6] * 3)

        if cfg.with_camera:
            cam = _camera_slice(cfg, pos, yaw, p_body, weights, device, native)
        else:
            cam = dict(
                cam_Lambdas=np.zeros((C.N_FEAT, 3, 3)),
                cam_thetas=np.zeros((C.N_FEAT, 3)),
                cam_etas=np.zeros((C.N_FEAT, C.VMF_N_LOBES, 3)),
                cam_weights=np.zeros(C.N_FEAT),
                cam_colors=np.zeros((C.N_FEAT, 3)),
                cam_valid=np.zeros(C.N_FEAT, bool),
            )

        batches.append(batch_from_numpy(dict(
            points=p_body,
            point_stamps=pt_times + cfg.t0,
            point_weights=weights,
            point_ring=np.zeros(cfg.n_points, np.int32),
            point_tag=np.zeros(cfg.n_points, np.int32),
            imu_stamps=imu_stamps + cfg.t0,
            imu_gyro=imu_gyro,
            imu_accel=imu_accel,
            odom_pose=odom_pose,
            odom_cov=odom_cov,
            odom_twist=odom_twist,
            odom_twist_cov=odom_twist_cov,
            odom_rel_pose=odom_rel,
            odom_rel_cov=odom_rel_cov,
            **cam,
            loop_pose=np.zeros(6),
            loop_cov=1e12 * np.eye(6),
            loop_weight=np.zeros(()),
            scan_start_time=np.asarray(scan_start + cfg.t0),
            scan_end_time=np.asarray(scan_end + cfg.t0),
            t_scan=np.asarray(t_scan + cfg.t0),
            t_last_scan=np.asarray(t_last_scan + cfg.t0),
            dt_sec=np.asarray(t_scan - t_last_scan),
            scan_seq=np.asarray(k, np.int32),
        ), device=device))
        t_last_scan = t_scan

    return SyntheticRun(batches=batches, gt_poses=gt_poses, gt_times=gt_times)
