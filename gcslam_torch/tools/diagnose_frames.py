"""First-principles coordinate-frame diagnostic from bag DATA (no guessing).

The reference's diagnose_coordinate_frames.py (tools/, 506 LoC) answers, from
the raw messages alone:

  1. LiDAR frame convention — Z-up vs Z-down, sensor height above ground,
     from the ground-plane return distribution of the first clouds;
  2. IMU frame convention — gravity direction in the IMU frame, specific-force
     vs acceleration sign, units (g vs m/s^2), gyro bias;
  3. odom conventions — covariance ordering sanity, quaternion normalization,
     planarity (z span), yaw-dominance of rotation;
  4. cross-stream consistency — odom yaw RATE vs integrated gyro z (sign flip
     = frame mismatch; scale error = units mismatch), odom heading vs
     displacement direction (holonomic check).

Usage:
  python -m gcslam_torch.tools.diagnose_frames bag.db3 [--max-scans 10] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

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


def diagnose_frames(db_path: str, max_scans: int = 10, max_msgs: int = 1000) -> dict:
    raw = rosbag.read_bag_messages(db_path)
    types = raw.pop("__types__")
    out: dict = {"path": db_path}

    # ---- 1. LiDAR Z convention from ground returns ------------------------
    lidar = next((n for n, t in types.items() if "PointCloud2" in t and raw.get(n)), None)
    if lidar:
        zs, ranges = [], []
        for _, buf in raw[lidar][:max_scans]:
            m = cdr.parse_pointcloud2(buf)
            xyz, _, _, _ = cdr.pointcloud2_to_arrays(m)
            ok = np.all(np.isfinite(xyz), axis=1) & (np.linalg.norm(xyz, axis=1) > 0.3)
            zs.append(xyz[ok, 2])
            ranges.append(np.linalg.norm(xyz[ok], axis=1))
        z = np.concatenate(zs) if zs else np.zeros(0)
        r = np.concatenate(ranges) if ranges else np.zeros(0)
        if z.size:
            # the densest z-slab below/above the sensor is the ground plane
            frac_below = float(np.mean(z < 0))
            z_ground = float(np.percentile(z, 5 if frac_below > 0.5 else 95))
            out["lidar"] = {
                "topic": lidar,
                "n_points_sampled": int(z.size),
                "frac_z_negative": round(frac_below, 3),
                "z_convention": "Z-up (ground below sensor)" if frac_below > 0.5
                else "Z-down or sensor below ground plane — CHECK",
                "est_sensor_height_m": round(abs(z_ground), 2),
                "range_p50_m": round(float(np.percentile(r, 50)), 2),
                "range_p95_m": round(float(np.percentile(r, 95)), 2),
            }

    # ---- 2. IMU gravity / units -------------------------------------------
    imu_t = next((n for n, t in types.items() if "Imu" in t and raw.get(n)), None)
    imus = []
    if imu_t:
        imus = [cdr.parse_imu(b) for _, b in raw[imu_t][:max_msgs]]
        acc = np.stack([m.linear_acceleration for m in imus])
        gyr = np.stack([m.angular_velocity for m in imus])
        a_mean = acc.mean(0)
        a_mag = float(np.linalg.norm(a_mean))
        g_dir = a_mean / max(a_mag, 1e-12)
        out["imu"] = {
            "topic": imu_t,
            "accel_mag_mean": round(a_mag, 3),
            "units_guess": "g (multiply by 9.81)" if 0.8 < a_mag < 1.2 else "m/s^2",
            "gravity_dir_imu_frame": [round(float(x), 4) for x in g_dir],
            "sign_convention": "specific force (+z up when level)" if g_dir[2] > 0.7
            else ("acceleration (-z when level)" if g_dir[2] < -0.7
                  else "TILTED or non-trivial mounting — run check_extrinsics"),
            "tilt_from_z_deg": round(float(np.degrees(np.arccos(np.clip(abs(g_dir[2]), 0, 1)))), 2),
            "gyro_bias_est": [round(float(x), 5) for x in gyr.mean(0)],
            "gyro_noise_std": [round(float(x), 5) for x in gyr.std(0)],
        }

    # ---- 3. odom conventions ----------------------------------------------
    odom_t = next((n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    odoms = []
    if odom_t:
        odoms = [(t, cdr.parse_odometry(b)) for t, b in raw[odom_t][:max_msgs]]
        pos = np.stack([m.position for _, m in odoms])
        quats = np.stack([m.orientation for _, m in odoms])
        qn = np.linalg.norm(quats, axis=1)
        yaws = np.unwrap([_yaw(q) for q in quats])
        rotvec_mag = 2 * np.arccos(np.clip(np.abs(quats[:, 3]), 0, 1))
        yaw_frac = float(np.mean(np.abs(yaws - yaws[0]) + 1e-12)
                         / np.mean(rotvec_mag - rotvec_mag[0] + np.abs(yaws - yaws[0]) + 1e-12))
        out["odom"] = {
            "topic": odom_t,
            "child_frame_id": odoms[0][1].child_frame_id,
            "quat_normalized": bool(np.all(np.abs(qn - 1.0) < 1e-3)),
            "z_span_m": round(float(pos[:, 2].max() - pos[:, 2].min()), 4),
            "planar": bool(pos[:, 2].max() - pos[:, 2].min() < 0.1),
            "xy_span_m": [round(float(pos[:, i].max() - pos[:, i].min()), 3) for i in (0, 1)],
            "rotation_is_yaw_dominated": bool(yaw_frac > 0.45),
        }

    # ---- 4. cross-stream consistency --------------------------------------
    if imus and odoms and len(odoms) > 3:
        t_o = np.array([t for t, _ in odoms])
        t_i = np.array([m.header.stamp_sec for m in imus])
        yaws = np.unwrap([_yaw(m.orientation) for _, m in odoms])
        # odom yaw change over the overlap vs integrated gyro z
        t0, t1 = max(t_o[0], t_i[0]), min(t_o[-1], t_i[-1])
        if t1 > t0:
            sel_o = (t_o >= t0) & (t_o <= t1)
            sel_i = (t_i >= t0) & (t_i <= t1)
            dyaw_odom = float(yaws[sel_o][-1] - yaws[sel_o][0]) if sel_o.sum() > 1 else 0.0
            gz = np.stack([m.angular_velocity for m in imus])[sel_i, 2]
            dyaw_gyro = float(np.trapezoid(gz, t_i[sel_i])) if sel_i.sum() > 1 else 0.0
            wz_odom = np.stack([m.twist_angular for _, m in odoms])[:, 2]
            agree = "UNDETERMINED (too little rotation)"
            if abs(dyaw_odom) > 0.02 or abs(dyaw_gyro) > 0.02:
                ratio = dyaw_gyro / dyaw_odom if abs(dyaw_odom) > 1e-6 else np.inf
                if 0.7 < ratio < 1.4:
                    agree = "AGREE (same sign, same scale)"
                elif -1.4 < ratio < -0.7:
                    agree = "SIGN FLIP — gyro z vs odom yaw frame mismatch"
                else:
                    agree = f"SCALE MISMATCH (gyro/odom dyaw ratio {ratio:.2f})"
            out["consistency"] = {
                "dyaw_odom_rad": round(dyaw_odom, 4),
                "dyaw_gyro_integrated_rad": round(dyaw_gyro, 4),
                "odom_yawrate_mean": round(float(wz_odom.mean()), 4),
                "verdict": agree,
            }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("--max-scans", type=int, default=10)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    info = diagnose_frames(args.bag, args.max_scans)
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        for section, body in info.items():
            if section == "path":
                continue
            print(f"[{section}]")
            for k, v in body.items():
                print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
