"""Turn-invariant check: gyro Z sign vs odometry yaw rate through real turns.

The reference's first-real-bag gyro-frame validator
(tools/check_turn_invariant.py:1-60 + validate_imu_gyro_frame.py): during a
left (CCW) turn on flat ground,

    mean gyro_base_z  > 0   (body yaw rate, after R_base_imu)
    odom yaw rate     > 0
    mean accel_base_y > 0   (centripetal specific force points left)

A gyro_base_z sign OPPOSITE to the odom yaw rate while accel_base_y agrees
means the gyro Z axis is flipped relative to the configured IMU extrinsic —
the classic silent killer of IMU evidence (the pipeline would fight every
turn). This tool selects high-|yaw-rate| windows from the odometry stream,
averages the base-frame IMU signals over each window, and reports per-window
signs plus the overall verdict.

Usage:
  python -m gcslam_torch.tools.check_turn_invariant bag.db3
         [--config configs/gc_kimera.yaml] [--yaw-thresh 0.15] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def check_turn_invariant(bag_path: str, config_path: str | None = None,
                         yaw_thresh: float = 0.15) -> dict:
    cfg = rosbag.bag_config_from_file(config_path) if config_path else None
    T_base_imu = np.asarray(cfg.T_base_imu if cfg else (0.0,) * 6)
    accel_scale = cfg.imu_accel_scale if cfg else 1.0
    R_bi = rosbag._rotvec_R(T_base_imu[3:6])

    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    imu_t = (cfg.imu_topic if cfg else None) or next(
        (n for n, t in types.items() if "Imu" in t and raw.get(n)), None)
    odom_t = (cfg.odom_topic if cfg else None) or next(
        (n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    if not imu_t or not odom_t or not raw.get(imu_t) or not raw.get(odom_t):
        return {"error": "need both an Imu and an Odometry topic",
                "topics": dict(types)}

    imus = [cdr.parse_imu(b) for _, b in raw[imu_t]]
    t_imu = np.asarray([m.header.stamp_sec for m in imus])
    gyro_base = np.stack([R_bi @ m.angular_velocity for m in imus])
    accel_base = np.stack([R_bi @ (m.linear_acceleration * accel_scale)
                           for m in imus])

    odoms = [cdr.parse_odometry(b) for _, b in raw[odom_t]]
    t_od = np.asarray([m.header.stamp_sec for m in odoms])
    wz_od = np.asarray([m.twist_angular[2] for m in odoms])

    # turn windows: contiguous runs of |wz_odom| above threshold
    turning = np.abs(wz_od) > yaw_thresh
    windows = []
    i = 0
    while i < len(turning):
        if turning[i]:
            j = i
            while j + 1 < len(turning) and turning[j + 1]:
                j += 1
            if t_od[j] - t_od[i] > 0.3:  # ignore blips
                windows.append((i, j))
            i = j + 1
        else:
            i += 1

    per_window = []
    agree = 0
    for i, j in windows:
        sel = (t_imu >= t_od[i]) & (t_imu <= t_od[j])
        if not np.any(sel):
            continue
        gz = float(np.mean(gyro_base[sel, 2]))
        ay = float(np.mean(accel_base[sel, 1]))
        wz = float(np.mean(wz_od[i:j + 1]))
        ok = bool(np.sign(gz) == np.sign(wz)) if abs(gz) > 0.02 else None
        agree += 1 if ok else 0
        per_window.append({
            "t0": round(float(t_od[i]), 3), "t1": round(float(t_od[j]), 3),
            "odom_wz_mean": round(wz, 4), "gyro_base_z_mean": round(gz, 4),
            "accel_base_y_mean": round(ay, 4),
            "signs_agree": ok,
        })

    checked = [w for w in per_window if w["signs_agree"] is not None]
    verdict = ("NO_TURNS" if not checked else
               "OK" if all(w["signs_agree"] for w in checked) else
               "GYRO_Z_FLIPPED" if not any(w["signs_agree"] for w in checked)
               else "MIXED")
    return {
        "imu_topic": imu_t, "odom_topic": odom_t,
        "R_base_imu_rotvec": [round(float(x), 5) for x in T_base_imu[3:6]],
        "yaw_thresh": yaw_thresh,
        "n_turn_windows": len(per_window),
        "windows": per_window,
        "verdict": verdict,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--config", default=None)
    p.add_argument("--yaw-thresh", type=float, default=0.15)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = check_turn_invariant(args.bag, args.config, args.yaw_thresh)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
        return 0 if info["verdict"] in ("OK", "NO_TURNS") else 1
    print(f"turn-invariant check  imu={info['imu_topic']} odom={info['odom_topic']}")
    print(f"  turn windows (|wz| > {info['yaw_thresh']} rad/s): {info['n_turn_windows']}")
    for w in info["windows"]:
        tag = {True: "ok", False: "SIGN MISMATCH", None: "gyro too quiet"}[w["signs_agree"]]
        print(f"  [{w['t0']:.1f}s..{w['t1']:.1f}s] odom_wz={w['odom_wz_mean']:+.3f} "
              f"gyro_z={w['gyro_base_z_mean']:+.3f} accel_y={w['accel_base_y_mean']:+.3f}  {tag}")
    print(f"  verdict: {info['verdict']}")
    return 0 if info["verdict"] in ("OK", "NO_TURNS") else 1


if __name__ == "__main__":
    sys.exit(main())
