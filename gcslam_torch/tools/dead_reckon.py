"""Dead-reckoning forensics: integrate each sensor stream independently and
report per-stream consistency — the offline equivalent of the reference's
inspect_*/diagnose_* bag scripts (SURVEY.md 2.9: dead reckoning, covariance
dumps, convention checks).

For a bag (or the synthetic rig) this prints, per stream:
  - odom: the raw odometry trajectory and its self-consistency (twist
    re-integration vs reported poses — catches frame/sign conventions);
  - imu: gyro-integrated yaw + gravity-direction tilt statistics
    (catches axis conventions and bias magnitudes);
  - cross-stream: odom-yaw vs gyro-yaw increments (catches time offsets
    and yaw-rate scale mismatches).

The batches come from load_bag or the generator on the CUDA card (on the
CPU with --cpu); `analyze` moves their fields to the host once and keeps
the analysis in float64 numpy.

Usage:
  python -m gcslam_torch.tools.dead_reckon [--bag path.db3] [--scans 160] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from gcslam_torch.models.scan_io import host_batches


def analyze(batches, gt_poses=None) -> dict:
    batches = host_batches(batches)
    odom = np.array([np.asarray(b.odom_pose) for b in batches])
    twist = np.array([np.asarray(b.odom_twist) for b in batches])
    dts = np.array([float(b.dt_sec) for b in batches])

    # 1. odom self-consistency: re-integrate body twist -> compare to poses
    pos = odom[0, :3].copy()
    yaw = odom[0, 5]
    errs = []
    for k in range(1, len(batches)):
        yaw += twist[k, 5] * dts[k]
        c, s = np.cos(yaw), np.sin(yaw)
        v_w = np.array([c * twist[k, 0] - s * twist[k, 1],
                        s * twist[k, 0] + c * twist[k, 1], twist[k, 2]])
        pos += v_w * dts[k]
        errs.append(np.linalg.norm(pos[:2] - odom[k, :2]))
    odom_twist_consistency = float(np.max(errs)) if errs else 0.0

    # 2. IMU: gyro yaw integration + accel tilt
    gyro_yaw = 0.0
    gyro_yaws, tilts = [], []
    for b in batches:
        st = np.asarray(b.imu_stamps)
        ok = st > 0
        if ok.sum() >= 2:
            dt = np.diff(st[ok]).mean()
            gz = np.asarray(b.imu_gyro)[ok, 2]
            gyro_yaw += float(gz.sum() * dt)
            acc = np.asarray(b.imu_accel)[ok]
            a = acc.mean(0)
            tilts.append(np.degrees(np.arctan2(np.linalg.norm(a[:2]), abs(a[2]))))
        gyro_yaws.append(gyro_yaw)
    gyro_yaws = np.asarray(gyro_yaws)

    # 3. cross-stream: odom yaw increments vs gyro yaw increments
    odom_dy = np.diff(np.unwrap(odom[:, 5]))
    gyro_dy = np.diff(gyro_yaws)
    n = min(len(odom_dy), len(gyro_dy))
    scale = float(np.polyfit(gyro_dy[:n], odom_dy[:n], 1)[0]) if n > 10 else 1.0

    report = {
        "n_scans": len(batches),
        "odom_twist_reintegration_max_err_m": odom_twist_consistency,
        "gyro_total_yaw_deg": float(np.degrees(gyro_yaws[-1])),
        "odom_total_yaw_deg": float(np.degrees(odom[-1, 5] - odom[0, 5])),
        "mean_accel_tilt_deg": float(np.mean(tilts)) if tilts else None,
        "odom_vs_gyro_yawrate_scale": scale,
    }
    if gt_poses is not None:
        gt = np.asarray(gt_poses)[: len(odom)]
        report["odom_xy_err_max_m"] = float(
            np.linalg.norm(odom[:, :2] - gt[:, :2], axis=1).max()
        )
        report["gyro_yaw_err_final_deg"] = float(
            np.degrees(gyro_yaws[-1] - (gt[-1, 5] - gt[0, 5]))
        )
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bag", default=None)
    p.add_argument("--scans", type=int, default=160)
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.bag:
        from gcslam_torch.frontend import rosbag

        batches, gt, _ = rosbag.load_bag(args.bag, n_points=args.points, device=device)
    else:
        from gcslam_torch.frontend.synthetic import generate, SyntheticConfig

        run = generate(SyntheticConfig(n_scans=args.scans, n_points=args.points), device=device)
        batches, gt = run.batches, run.gt_poses
    report = analyze(batches, gt)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
