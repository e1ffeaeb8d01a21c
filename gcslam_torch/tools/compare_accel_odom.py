"""Compare IMU accel (gravity direction) with odom orientation, per sample.

The reference's compare_accel_odom.py (tools/, 108 LoC): for each IMU sample,
rotate accel into base via R_base_imu and compare with the gravity direction
the odom orientation predicts (g_body = R_odom^T g_world as specific force).
If the extrinsic AND the odom frame are right, the normalized dot product is
~1 when (near-)stationary. Reads straight off the bag (the reference needs
pre-dumped CSVs); nearest-in-time odom per IMU sample.

Output: mean/min/max dot product + verdict, optional per-sample CSV.

Usage:
  python -m gcslam_torch.tools.compare_accel_odom bag.db3
         [--config configs/gc_kimera.yaml] [--max 2000] [--csv out.csv] [--json]
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


def compare_accel_odom(bag_path: str, config_path: str | None = None,
                       max_samples: int = 2000) -> dict:
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
                "topics": {n: t for n, t in types.items()}}

    imus = [cdr.parse_imu(b) for _, b in raw[imu_t][:max_samples]]
    odoms = [(t, cdr.parse_odometry(b)) for t, b in raw[odom_t]]
    t_odom = np.asarray([t for t, _ in odoms])

    # specific force when stationary: a = -R_wb^T g = R_odom^T [0,0,+9.81]
    g_world = np.array([0.0, 0.0, 9.81])
    dots, rows = [], []
    for m in imus:
        j = int(np.argmin(np.abs(t_odom - m.header.stamp_sec)))
        R_odom = _quat_to_R(np.asarray(odoms[j][1].orientation))
        a_base = R_bi @ (np.asarray(m.linear_acceleration) * accel_scale)
        g_body = R_odom.T @ g_world
        a_n = a_base / max(np.linalg.norm(a_base), 1e-12)
        g_n = g_body / max(np.linalg.norm(g_body), 1e-12)
        d = float(a_n @ g_n)
        dots.append(d)
        rows.append((m.header.stamp_sec, d, *a_base))
    dots = np.asarray(dots)
    mean_dot = float(dots.mean())
    verdict = ("accel agrees with odom orientation" if mean_dot > 0.99
               else "mostly agrees; small frame or timing offset" if mean_dot > 0.95
               else "DISAGREE — frame, scale, or timing problem")
    return {
        "imu_topic": imu_t,
        "odom_topic": odom_t,
        "n_samples": int(dots.size),
        "T_base_imu_rotvec": [float(x) for x in T_base_imu[3:6]],
        "dot_mean": round(mean_dot, 4),
        "dot_min": round(float(dots.min()), 4),
        "dot_max": round(float(dots.max()), 4),
        "dot_p05": round(float(np.percentile(dots, 5)), 4),
        "verdict": verdict,
        "_rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("--config", default=None, help="run config with frontend: extrinsics")
    ap.add_argument("--max", type=int, default=2000)
    ap.add_argument("--csv", default=None, metavar="PATH")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    info = compare_accel_odom(args.bag, args.config, args.max)
    if "error" in info:
        print(json.dumps(info), file=sys.stderr)
        return 1
    rows = info.pop("_rows")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("stamp_sec,dot,a_base_x,a_base_y,a_base_z\n")
            for r in rows:
                f.write(",".join(f"{x:.6f}" for x in r) + "\n")
        info["csv"] = args.csv
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        print("Accel vs odom (gravity direction agreement)")
        print(f"  dot(normalized a_base, g_body): mean={info['dot_mean']} "
              f"min={info['dot_min']} max={info['dot_max']} p05={info['dot_p05']}")
        print(f"  -> {info['verdict']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
