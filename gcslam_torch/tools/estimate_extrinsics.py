"""Extrinsic/gravity estimation forensics — offline equivalent of the
reference's estimate_* tools (SURVEY.md 2.9: extrinsic estimation from
ground plane / gravity).

Estimates, from a bag or the synthetic rig:
  - the IMU mounting tilt: rotation aligning mean specific force (at rest /
    low dynamics) with -gravity;
  - the LiDAR mounting tilt + height: ground-plane fit (RANSAC-free: robust
    lowest-quantile z slab + least-squares plane) in the sensor frame;
  - a consistency check between the two (both should report the same
    base-frame tilt when the frames are calibrated).

The batches come from load_bag or the generator on the CUDA card (on the
CPU with --cpu); both estimates move their fields to the host once
(models/scan_io.host_batches) and stay in numpy.

Usage:
  python -m gcslam_torch.tools.estimate_extrinsics [--bag path.db3] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from gcslam_torch.models.scan_io import host_batches


def estimate_imu_gravity(batches, low_dyn_quantile: float = 0.25) -> dict:
    """Mean accel direction over the lowest-|gyro| windows -> tilt."""
    rows = []
    for b in host_batches(batches):
        st = np.asarray(b.imu_stamps)
        ok = st > 0
        if ok.sum() < 2:
            continue
        g = np.asarray(b.imu_gyro)[ok]
        a = np.asarray(b.imu_accel)[ok]
        rows.append((float(np.linalg.norm(g, axis=1).mean()), a.mean(0)))
    if not rows:
        return {"valid": False}
    rows.sort(key=lambda r: r[0])
    take = max(1, int(len(rows) * low_dyn_quantile))
    a_mean = np.mean([r[1] for r in rows[:take]], axis=0)
    a_hat = a_mean / (np.linalg.norm(a_mean) + 1e-12)
    tilt = float(np.degrees(np.arccos(np.clip(a_hat[2], -1, 1))))
    return {
        "valid": True,
        "accel_mean_mps2": [float(x) for x in a_mean],
        "specific_force_norm": float(np.linalg.norm(a_mean)),
        "imu_tilt_deg": tilt,
    }


def estimate_lidar_ground(batches, n_use: int = 20) -> dict:
    """Ground plane in the LiDAR frame from the lowest-z slab of points."""
    pts = []
    for b in host_batches(batches[: n_use]):
        p = np.asarray(b.points)
        w = np.asarray(b.point_weights)
        pts.append(p[w > 0])
    if not pts:
        return {"valid": False}
    p = np.concatenate(pts, axis=0)
    z_lo = np.quantile(p[:, 2], 0.02)
    slab = p[np.abs(p[:, 2] - z_lo) < 0.15]
    if slab.shape[0] < 100:
        return {"valid": False}
    c = slab.mean(0)
    q = slab - c
    _, _, Vt = np.linalg.svd(q, full_matrices=False)
    n = Vt[2]
    if n[2] < 0:
        n = -n
    tilt = float(np.degrees(np.arccos(np.clip(n[2], -1, 1))))
    height = float(-(c @ n) / (n[2] + 1e-12) * n[2]) if n[2] > 0.5 else None
    return {
        "valid": True,
        "ground_normal_lidar": [float(x) for x in n],
        "lidar_tilt_deg": tilt,
        "sensor_height_m": float(abs(c @ n)),
        "n_ground_points": int(slab.shape[0]),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bag", default=None)
    p.add_argument("--scans", type=int, default=40)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.bag:
        from gcslam_torch.frontend import rosbag

        batches, _, _ = rosbag.load_bag(args.bag, n_points=args.points, device=device)
    else:
        from gcslam_torch.frontend.synthetic import generate, SyntheticConfig

        run = generate(SyntheticConfig(n_scans=args.scans, n_points=args.points), device=device)
        batches = run.batches
    out = {
        "imu_gravity": estimate_imu_gravity(batches),
        "lidar_ground": estimate_lidar_ground(batches),
    }
    ig, lg = out["imu_gravity"], out["lidar_ground"]
    if ig.get("valid") and lg.get("valid"):
        out["tilt_consistency_deg"] = abs(ig["imu_tilt_deg"] - lg["lidar_tilt_deg"])
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
