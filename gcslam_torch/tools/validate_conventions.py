"""Empirically validate frame / quaternion / unit conventions from bag DATA.

Consolidated analog of four reference scripts (tools/):
  validate_frame_conventions.py  — odom frame stability, yaw trace, IMU accel
                                   magnitude, gyro-z-vs-odom-yaw-rate sign
                                   correlation after T_base_imu, gravity
                                   alignment of configured extrinsics
  validate_imu_gyro_frame.py     — gyro frame sign check
  confirm_remaining_conventions.py, test_frame_transforms.py — quaternion
                                   normalization + rotvec/quat roundtrips

No gating: continuous statistics, thresholds only in the printed verdicts.

Usage:
  python -m gcslam_torch.tools.validate_conventions bag.db3 \
      [--t-base-imu rx,ry,rz] [--json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _quat_to_R(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / max(np.linalg.norm(q), 1e-12)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _yaw(q: np.ndarray) -> float:
    x, y, z, w = q
    return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))


def validate_conventions(
    db_path: str,
    t_base_imu_rotvec: np.ndarray | None = None,
    max_msgs: int = 2000,
) -> dict:
    raw = rosbag.read_bag_messages(db_path)
    types = raw.pop("__types__")
    out: dict = {"path": db_path}

    odom_topic = next((n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    imu_topic = next((n for n, t in types.items() if t.endswith("Imu") and raw.get(n)), None)

    # ---- odometry: frame stability, quaternion norm, yaw trace ------------
    if odom_topic:
        odoms = [cdr.parse_odometry(b) for _, b in raw[odom_topic][:max_msgs]]
        frames = sorted({m.header.frame_id for m in odoms})
        children = sorted({m.child_frame_id for m in odoms})
        qn = np.array([np.linalg.norm(m.orientation) for m in odoms])
        yaws = np.unwrap([_yaw(m.orientation) for m in odoms])
        ts = np.array([m.header.stamp_sec for m in odoms])
        dt = np.diff(ts)
        ok = dt > 1e-6
        yaw_rate = np.diff(yaws)[ok] / dt[ok]
        out["odom"] = {
            "topic": odom_topic,
            "n": len(odoms),
            "frame_ids": frames,
            "child_frame_ids": children,
            "frame_stable": len(frames) == 1 and len(children) <= 1,
            "quat_norm_max_dev": float(np.abs(qn - 1.0).max()) if len(qn) else None,
            "yaw_span_deg": float(np.degrees(yaws.max() - yaws.min())) if len(yaws) else 0.0,
            "yaw_rate_mean": float(np.mean(yaw_rate)) if len(yaw_rate) else 0.0,
            "yaw_rate_abs_p95": float(np.percentile(np.abs(yaw_rate), 95)) if len(yaw_rate) else 0.0,
        }

    # ---- IMU: accel magnitude (units), gyro stats --------------------------
    if imu_topic:
        imus = [cdr.parse_imu(b) for _, b in raw[imu_topic][:max_msgs]]
        acc = np.array([m.linear_acceleration for m in imus])
        gyr = np.array([m.angular_velocity for m in imus])
        amag = np.linalg.norm(acc, axis=1)
        med = float(np.median(amag)) if len(amag) else 0.0
        # units verdict: ~9.81 => m/s^2; ~1.0 => g (reference
        # validate_frame_conventions.py reports raw + scaled stats)
        units = "m/s^2" if abs(med - 9.81) < 2.0 else ("g" if abs(med - 1.0) < 0.3 else "unknown")
        out["imu"] = {
            "topic": imu_topic,
            "n": len(imus),
            "accel_mag_median": med,
            "accel_mag_std": float(np.std(amag)) if len(amag) else 0.0,
            "accel_units_verdict": units,
            "gyro_bias_est": [float(v) for v in np.median(gyr, axis=0)] if len(gyr) else None,
        }

        # gravity alignment of configured T_base_imu: mean specific force,
        # rotated to base, should point +z (specific force = -gravity).
        R_bi = rosbag._rotvec_R(np.asarray(t_base_imu_rotvec, float)) if t_base_imu_rotvec is not None else np.eye(3)
        g_base = R_bi @ np.mean(acc, axis=0)
        gz = float(g_base[2] / max(np.linalg.norm(g_base), 1e-12))
        out["gravity_alignment"] = {
            "t_base_imu_applied": t_base_imu_rotvec is not None,
            "mean_specific_force_base": [float(v) for v in g_base],
            "cos_to_plus_z": gz,
            "aligned": bool(gz > 0.95),
        }

    # ---- cross-stream: gyro z sign vs odom yaw-rate sign -------------------
    if odom_topic and imu_topic and out["odom"]["n"] > 2 and out["imu"]["n"] > 2:
        imus_t = np.array([m.header.stamp_sec for m in imus])
        R_bi = rosbag._rotvec_R(np.asarray(t_base_imu_rotvec, float)) if t_base_imu_rotvec is not None else np.eye(3)
        gz_base = (gyr @ R_bi.T)[:, 2]
        # resample odom yaw rate onto imu stamps (within odom time range)
        mid_t = 0.5 * (ts[1:] + ts[:-1])
        ok = dt > 1e-6
        if ok.sum() > 2:
            wz_od = np.interp(imus_t, mid_t[ok], np.diff(yaws)[ok] / dt[ok])
            sel = (imus_t >= ts[0]) & (imus_t <= ts[-1]) & (np.abs(wz_od) > 0.02)
            if sel.sum() > 5:
                # cosine similarity, not Pearson: a constant yaw rate (e.g.
                # steady circling) has zero variance and makes correlation
                # meaningless, but the SIGN agreement is exactly what the
                # convention check needs.
                num = float(np.sum(gz_base[sel] * wz_od[sel]))
                den = float(np.linalg.norm(gz_base[sel]) * np.linalg.norm(wz_od[sel]))
                corr = num / max(den, 1e-12)
            else:
                corr = 0.0
            out["gyro_vs_odom_yawrate"] = {
                "cosine": corr,
                "n_used": int(sel.sum()),
                "sign_consistent": bool(corr > 0.5),
                "sign_flipped": bool(corr < -0.5),
            }

    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("--t-base-imu", default=None,
                    help="rotvec rx,ry,rz of T_base_imu rotation")
    ap.add_argument("--max-msgs", type=int, default=2000)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rv = (np.array([float(v) for v in args.t_base_imu.split(",")])
          if args.t_base_imu else None)
    rep = validate_conventions(args.bag, rv, args.max_msgs)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        for k, v in rep.items():
            print(f"{k}: {json.dumps(v)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
