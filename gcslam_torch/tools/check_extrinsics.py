"""Extrinsics checker: print the configured T_base_* and VALIDATE them
against bag data.

The reference's check_extrinsics.py (tools/, 117 LoC) prints T_base_lidar /
T_base_imu from the config; its sibling diagnostics then eyeball-validate.
This tool does both in one pass:

  - prints each configured 6D extrinsic [t(3), rotvec(3)], its rotation
    magnitude, and the implied sensor orientation;
  - IMU check: rotates the bag's mean specific-force into base via R_base_imu
    and reports the residual tilt from +Z — a correctly-calibrated planar rig
    at rest should land within a few degrees of vertical;
  - LiDAR check: applies T_base_lidar to the first scans and reports the
    ground-plane z in base frame (should be ~ -wheel_height, not +);
  - fails (exit 2) when the IMU tilt residual exceeds --tilt-max-deg.

Usage:
  python -m gcslam_torch.tools.check_extrinsics configs/gc_kimera.yaml
         [--bag bag.db3] [--tilt-max-deg 10] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _fmt6(v) -> str:
    return "[" + ", ".join(f"{float(x):+.6f}" for x in v) + "]"


def check_extrinsics(config_path: str, bag_path: str | None = None) -> dict:
    cfg = rosbag.bag_config_from_file(config_path)
    if cfg is None:
        return {"error": f"{config_path} has no `frontend:` section"}
    out: dict = {"config": config_path}
    for name in ("T_base_lidar", "T_base_imu", "T_base_camera"):
        v = np.asarray(getattr(cfg, name), dtype=np.float64)
        R = rosbag._rotvec_R(v[3:6])
        out[name] = {
            "value": [float(x) for x in v],
            "trans_norm_m": round(float(np.linalg.norm(v[:3])), 4),
            "rot_deg": round(float(np.degrees(np.linalg.norm(v[3:6]))), 3),
            "sensor_z_axis_in_base": [round(float(x), 4) for x in R[:, 2]],
            "identity": bool(np.all(v == 0.0)),
        }
    if out["T_base_lidar"]["identity"] and out["T_base_imu"]["identity"]:
        out["warning"] = ("both T_base_lidar and T_base_imu are IDENTITY — "
                          "wrong extrinsics silently corrupt every evidence factor")

    if bag_path:
        raw = rosbag.read_bag_messages(bag_path)
        types = raw.pop("__types__")
        # IMU: residual tilt of gravity in base frame
        imu_t = cfg.imu_topic or next(
            (n for n, t in types.items() if "Imu" in t and raw.get(n)), None)
        if imu_t and raw.get(imu_t):
            acc = np.stack([cdr.parse_imu(b).linear_acceleration
                            for _, b in raw[imu_t][:1000]]) * cfg.imu_accel_scale
            a_imu = acc.mean(0)
            R_bi = rosbag._rotvec_R(np.asarray(cfg.T_base_imu[3:6]))
            a_base = R_bi @ a_imu
            tilt = float(np.degrees(np.arccos(
                np.clip(a_base[2] / max(np.linalg.norm(a_base), 1e-9), -1, 1))))
            out["imu_check"] = {
                "topic": imu_t,
                "accel_mean_imu_frame": [round(float(x), 3) for x in a_imu],
                "accel_mean_base_frame": [round(float(x), 3) for x in a_base],
                "tilt_from_vertical_deg": round(tilt, 2),
                "accel_mag": round(float(np.linalg.norm(a_base)), 3),
            }
        # LiDAR: ground plane z in base frame
        lid_t = cfg.lidar_topic or next(
            (n for n, t in types.items() if "PointCloud2" in t and raw.get(n)), None)
        if lid_t and raw.get(lid_t):
            R_bl = rosbag._rotvec_R(np.asarray(cfg.T_base_lidar[3:6]))
            t_bl = np.asarray(cfg.T_base_lidar[:3])
            zs = []
            for _, buf in raw[lid_t][:5]:
                xyz, _, _, _ = cdr.pointcloud2_to_arrays(cdr.parse_pointcloud2(buf))
                ok = np.all(np.isfinite(xyz), axis=1) & (np.linalg.norm(xyz, axis=1) > 0.3)
                zs.append((xyz[ok] @ R_bl.T + t_bl)[:, 2])
            if zs:
                z = np.concatenate(zs)
                out["lidar_check"] = {
                    "topic": lid_t,
                    "ground_z_base_p05_m": round(float(np.percentile(z, 5)), 3),
                    "frac_below_base_origin": round(float(np.mean(z < 0)), 3),
                }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="unified run config YAML (frontend: section)")
    ap.add_argument("--bag", default=None, help="validate against this bag's data")
    ap.add_argument("--tilt-max-deg", type=float, default=10.0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    info = check_extrinsics(args.config, args.bag)
    if "error" in info:
        print(json.dumps(info), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        for name in ("T_base_lidar", "T_base_imu", "T_base_camera"):
            e = info[name]
            print(f"{name}: {_fmt6(e['value'])}")
            print(f"  |t| = {e['trans_norm_m']} m, |rot| = {e['rot_deg']} deg, "
                  f"sensor +Z in base = {e['sensor_z_axis_in_base']}"
                  + ("  [IDENTITY]" if e["identity"] else ""))
        if "warning" in info:
            print(f"WARNING: {info['warning']}")
        if "imu_check" in info:
            c = info["imu_check"]
            print(f"IMU gravity in base: {c['accel_mean_base_frame']} "
                  f"(tilt {c['tilt_from_vertical_deg']} deg from vertical, "
                  f"|a| = {c['accel_mag']})")
        if "lidar_check" in info:
            c = info["lidar_check"]
            print(f"LiDAR ground plane in base: z_p05 = {c['ground_z_base_p05_m']} m, "
                  f"{c['frac_below_base_origin']:.0%} of returns below base origin")
    tilt = info.get("imu_check", {}).get("tilt_from_vertical_deg")
    if tilt is not None and tilt > args.tilt_max_deg:
        print(f"FAIL: IMU tilt residual {tilt} deg > {args.tilt_max_deg} deg — "
              "T_base_imu rotation is wrong (or the rig was not level)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
