"""Compare the IMU topics in a bag and recommend which to feed the pipeline.

The reference's tools/compare_imu_sources.py:1-238 (camera IMU vs Livox IMU):
for every Imu topic report
  - gravity direction over stable samples + misalignment from body -Z/+Z and
    the rotvec that would level it (a T_base_imu rotation candidate),
  - noise floors (high-passed gyro/accel std per axis + RMS),
  - data quality: rate, dropouts (gaps > 3x median dt), accel-unit guess
    (|a|~1 => g units, needs imu_accel_scale=9.81),
then recommend the topic with the lowest gyro noise among those without
dropouts.

Usage:
  python -m gcslam_torch.tools.compare_imu_sources bag.db3
         [--topics /a/imu /b/imu] [--max 10000] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _analyze_topic(msgs) -> dict:
    t = np.asarray([m.header.stamp_sec for m in msgs])
    gyro = np.stack([m.angular_velocity for m in msgs])
    accel = np.stack([m.linear_acceleration for m in msgs])

    dt = np.diff(t)
    med_dt = float(np.median(dt)) if len(dt) else 0.0
    rate = 1.0 / med_dt if med_dt > 0 else 0.0
    dropouts = int((dt > 3 * med_dt).sum()) if med_dt > 0 else 0

    a_mag = np.linalg.norm(accel, axis=1)
    unit_scale = 9.81 if 0.8 < float(a_mag.mean()) < 1.2 else 1.0

    # gravity from stable samples (|a| within 1 std of its mean)
    stable = np.abs(a_mag - a_mag.mean()) < max(float(a_mag.std()), 1e-9)
    g_vec = accel[stable].mean(0) if stable.any() else accel.mean(0)
    g_dir = g_vec / max(np.linalg.norm(g_vec), 1e-12)
    # a stationary IMU measures specific force = -g => +Z up sensors read
    # +9.81 on Z; misalignment = angle(g_dir, +Z)
    mis = float(np.degrees(np.arccos(np.clip(g_dir[2], -1, 1))))
    # rotation leveling the sensor: axis = g_dir x z, angle = mis
    axis = np.cross(g_dir, [0.0, 0.0, 1.0])
    s = np.linalg.norm(axis)
    rot_to_base = (axis / s * np.radians(mis)) if s > 1e-9 else np.zeros(3)

    # noise: first-difference high-pass (kills bias + slow motion), std/sqrt(2)
    def hp_std(x):
        return (np.diff(x, axis=0).std(axis=0) / np.sqrt(2.0)) if len(x) > 2 \
            else np.zeros(x.shape[1])

    gyro_n = hp_std(gyro)
    accel_n = hp_std(accel * unit_scale)
    return {
        "n": len(msgs),
        "rate_hz": round(rate, 1),
        "dropouts": dropouts,
        "accel_mag_mean": round(float(a_mag.mean()), 3),
        "accel_units_guess": "g (set imu_accel_scale: 9.81)" if unit_scale == 9.81
                             else "m/s^2",
        "gravity_dir": [round(float(x), 4) for x in g_dir],
        "misalignment_deg": round(mis, 2),
        "rotation_to_base_rotvec": [round(float(x), 5) for x in rot_to_base],
        "stable_frac": round(float(stable.mean()), 3),
        "gyro_noise_std": [round(float(x), 6) for x in gyro_n],
        "gyro_noise_rms": round(float(np.sqrt((gyro_n ** 2).mean())), 6),
        "accel_noise_std": [round(float(x), 5) for x in accel_n],
        "accel_noise_rms": round(float(np.sqrt((accel_n ** 2).mean())), 5),
    }


def compare_imu_sources(bag_path: str, topics=None, max_msgs: int = 10000) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    if not topics:
        topics = [n for n, t in types.items() if "Imu" in t and raw.get(n)]
    if not topics:
        return {"error": f"no Imu topics in {bag_path}", "topics": dict(types)}

    per = {}
    for tp in topics:
        if not raw.get(tp):
            per[tp] = {"error": "topic empty or absent"}
            continue
        per[tp] = _analyze_topic([cdr.parse_imu(b) for _, b in raw[tp][:max_msgs]])

    ok = {tp: a for tp, a in per.items() if "error" not in a}
    clean = {tp: a for tp, a in ok.items() if a["dropouts"] == 0} or ok
    rec = min(clean, key=lambda tp: clean[tp]["gyro_noise_rms"]) if clean else None
    return {"sources": per, "recommended": rec,
            "reason": "lowest gyro noise RMS among dropout-free topics"
                      if rec else "no usable Imu topic"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--topics", nargs="*", default=None)
    p.add_argument("--max", type=int, default=10000)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = compare_imu_sources(args.bag, args.topics, args.max)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
        return 0
    for tp, a in info["sources"].items():
        if "error" in a:
            print(f"{tp}: {a['error']}")
            continue
        print(f"{tp}  {a['rate_hz']} Hz  n={a['n']}  dropouts={a['dropouts']}")
        print(f"  gravity dir {a['gravity_dir']}  misalign {a['misalignment_deg']} deg"
              f"  level rotvec {a['rotation_to_base_rotvec']}")
        print(f"  gyro noise rms {a['gyro_noise_rms']} rad/s   "
              f"accel noise rms {a['accel_noise_rms']} m/s^2   "
              f"units: {a['accel_units_guess']}")
    print(f"recommended: {info['recommended']}  ({info['reason']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
