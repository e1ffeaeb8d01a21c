"""Dump raw IMU and odometry messages from a bag to CSV for inspection.

The reference's tools/dump_raw_imu_odom.py:1-138: two CSVs
(imu_raw_first_N.csv / odom_raw_first_N.csv) with one row per message —
used to eyeball tangent-frame conventions, gravity alignment, and the
covariance structure before trusting a new bag. Column layout matches the
reference (stamp_sec, gyro wx..wz, accel ax..az; odom adds pose, quaternion,
twist and the 6x6 covariance diagonals).

Usage:
  python -m gcslam_torch.tools.dump_raw_imu_odom bag.db3
         [--max-imu 300] [--max-odom 300] [--out-dir /tmp]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def dump_raw_imu_odom(bag_path: str, out_dir: str = ".",
                      max_imu: int = 300, max_odom: int = 300,
                      imu_topic: str | None = None,
                      odom_topic: str | None = None) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    imu_topic = imu_topic or next(
        (n for n, t in types.items() if "Imu" in t and raw.get(n)), None)
    odom_topic = odom_topic or next(
        (n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    os.makedirs(out_dir, exist_ok=True)
    out = {}

    if imu_topic and raw.get(imu_topic):
        path = os.path.join(out_dir, f"imu_raw_first_{max_imu}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["stamp_sec", "bag_sec", "wx", "wy", "wz",
                        "ax", "ay", "az", "qx", "qy", "qz", "qw"])
            for bag_t, buf in raw[imu_topic][:max_imu]:
                m = cdr.parse_imu(buf)
                w.writerow([f"{m.header.stamp_sec:.9f}", f"{bag_t:.9f}",
                            *[f"{v:.9g}" for v in m.angular_velocity],
                            *[f"{v:.9g}" for v in m.linear_acceleration],
                            *[f"{v:.9g}" for v in m.orientation]])
        out["imu_csv"] = path
        out["imu_topic"] = imu_topic

    if odom_topic and raw.get(odom_topic):
        path = os.path.join(out_dir, f"odom_raw_first_{max_odom}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["stamp_sec", "bag_sec", "x", "y", "z",
                        "qx", "qy", "qz", "qw", "vx", "vy", "vz",
                        "wx", "wy", "wz",
                        "pcov_xx", "pcov_yy", "pcov_zz",
                        "pcov_rr", "pcov_pp", "pcov_yaw",
                        "tcov_vx", "tcov_wz"])
            for bag_t, buf in raw[odom_topic][:max_odom]:
                m = cdr.parse_odometry(buf)
                pc = np.asarray(m.pose_cov).reshape(6, 6)
                tc = np.asarray(m.twist_cov).reshape(6, 6)
                w.writerow([f"{m.header.stamp_sec:.9f}", f"{bag_t:.9f}",
                            *[f"{v:.9g}" for v in m.position],
                            *[f"{v:.9g}" for v in m.orientation],
                            *[f"{v:.9g}" for v in m.twist_linear],
                            *[f"{v:.9g}" for v in m.twist_angular],
                            *[f"{pc[i, i]:.6g}" for i in range(6)],
                            f"{tc[0, 0]:.6g}", f"{tc[5, 5]:.6g}"])
        out["odom_csv"] = path
        out["odom_topic"] = odom_topic

    if not out:
        out["error"] = f"no Imu or Odometry topics in {bag_path}"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--max-imu", type=int, default=300)
    p.add_argument("--max-odom", type=int, default=300)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--imu-topic", default=None)
    p.add_argument("--odom-topic", default=None)
    args = p.parse_args(argv)
    info = dump_raw_imu_odom(args.bag, args.out_dir, args.max_imu,
                             args.max_odom, args.imu_topic, args.odom_topic)
    if "error" in info:
        print(info["error"], file=sys.stderr)
        return 1
    for k, v in info.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
