"""Apply an IMU->base extrinsic rotation to a raw IMU CSV dump.

Analog of reference tools/apply_imu_extrinsic_to_csv.py: takes the CSV
written by `dump_raw_imu_odom` (columns stamp_sec, bag_sec, wx, wy, wz,
ax, ay, az) and a rotation (rotvec), writes a new CSV with gyro and accel
rotated into the base frame — the quick way to check an extrinsic candidate
against plots/comparators without re-running anything.

Usage:
  python -m gcslam_torch.tools.apply_imu_extrinsic imu_raw.csv \
      --rotvec rx,ry,rz [--out imu_base.csv]
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from gcslam_torch.frontend.rosbag import _rotvec_R


def apply_imu_extrinsic(csv_in: str, rotvec: np.ndarray, csv_out: str) -> dict:
    R = _rotvec_R(np.asarray(rotvec, float))
    with open(csv_in) as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    idx = {name: i for i, name in enumerate(header)}
    need = ["wx", "wy", "wz", "ax", "ay", "az"]
    if any(n not in idx for n in need):
        raise ValueError(f"CSV must have columns {need}; got {header}")
    w = np.array([[float(r[idx[c]]) for c in ("wx", "wy", "wz")] for r in body])
    a = np.array([[float(r[idx[c]]) for c in ("ax", "ay", "az")] for r in body])
    wb = w @ R.T
    ab = a @ R.T
    with open(csv_out, "w", newline="") as f:
        wcsv = csv.writer(f)
        wcsv.writerow(header)
        for r, wrow, arow in zip(body, wb, ab):
            r = list(r)
            for j, c in enumerate(("wx", "wy", "wz")):
                r[idx[c]] = f"{wrow[j]:.9f}"
            for j, c in enumerate(("ax", "ay", "az")):
                r[idx[c]] = f"{arow[j]:.9f}"
            wcsv.writerow(r)
    return {
        "in": csv_in, "out": csv_out, "n_rows": len(body),
        "rotvec": [float(v) for v in rotvec],
        "mean_accel_base": [float(v) for v in ab.mean(axis=0)] if len(ab) else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csv_in")
    ap.add_argument("--rotvec", required=True, help="rx,ry,rz (radians)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rv = np.array([float(v) for v in args.rotvec.split(",")])
    out = args.out or args.csv_in.replace(".csv", "_base.csv")
    rep = apply_imu_extrinsic(args.csv_in, rv, out)
    import json

    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
