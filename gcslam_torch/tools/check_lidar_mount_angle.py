"""LiDAR mounting-angle check from raw point-cloud geometry.

The reference's tools/check_lidar_mount_angle.py:1-250: PCA the sensor-frame
point clouds of early (ideally stationary) scans and look at the principal
axes relative to the sensor Z axis. A horizontally-mounted spinning LiDAR
sees most variance in the scan plane, so the SMALLEST-variance axis (PC3)
should sit near vertical; a PC3 tilted ~45 deg means the unit is mounted at
an angle and T_base_lidar's rotation needs estimating (use
estimate_extrinsics). We add a ground-plane cross-check: RANSAC-lite fit of
the dominant low-z plane; its normal's tilt from +Z is a direct read of the
mount pitch/roll the PCA can only hint at.

Usage:
  python -m gcslam_torch.tools.check_lidar_mount_angle bag.db3
         [--topic /lidar/points] [--n-scans 10] [--skip 5] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _pca_stats(xyz: np.ndarray) -> dict | None:
    xyz = xyz[np.all(np.isfinite(xyz), axis=1)]
    if xyz.shape[0] < 50:
        return None
    c = xyz - xyz.mean(0)
    w, v = np.linalg.eigh(np.cov(c.T))
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order]
    z = np.array([0.0, 0.0, 1.0])
    ang = lambda u: float(np.degrees(np.arccos(np.clip(abs(u @ z), -1, 1))))
    return {
        "eigvals": [float(x) for x in w],
        "angle_pc1_z_deg": ang(v[:, 0]),
        "angle_pc3_z_deg": ang(v[:, 2]),
        "flatness": float(w[2] / max(w[0], 1e-12)),
        "z_std": float(xyz[:, 2].std()),
    }


def _ground_normal(xyz: np.ndarray, iters: int = 30) -> np.ndarray | None:
    """Cheap RANSAC plane on the below-median-z points; returns unit normal
    (oriented +z) or None."""
    pts = xyz[np.all(np.isfinite(xyz), axis=1)]
    pts = pts[pts[:, 2] < np.median(pts[:, 2])]
    if pts.shape[0] < 100:
        return None
    rng = np.random.default_rng(0)
    best_n, best_cnt = None, 0
    for _ in range(iters):
        s = pts[rng.choice(pts.shape[0], 3, replace=False)]
        n = np.cross(s[1] - s[0], s[2] - s[0])
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        d = np.abs((pts - s[0]) @ n)
        cnt = int((d < 0.05).sum())
        if cnt > best_cnt:
            best_cnt, best_n = cnt, n
    if best_n is None or best_cnt < 0.3 * pts.shape[0]:
        return None
    return best_n if best_n[2] >= 0 else -best_n


def check_lidar_mount_angle(bag_path: str, topic: str | None = None,
                            n_scans: int = 10, skip: int = 5) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    if topic is None:
        topic = next((n for n, t in types.items()
                      if "PointCloud2" in t and raw.get(n)), None)
    if topic is None or not raw.get(topic):
        return {"error": f"no PointCloud2 topic in {bag_path}",
                "topics": dict(types)}

    stats, normals = [], []
    for _, buf in raw[topic][skip:skip + n_scans]:
        xyz, _, _, _ = cdr.pointcloud2_to_arrays(cdr.parse_pointcloud2(buf))
        s = _pca_stats(np.asarray(xyz))
        if s:
            stats.append(s)
        n = _ground_normal(np.asarray(xyz))
        if n is not None:
            normals.append(n)
    if not stats:
        return {"error": "no parseable scans", "topic": topic}

    pc3 = float(np.mean([s["angle_pc3_z_deg"] for s in stats]))
    pc1 = float(np.mean([s["angle_pc1_z_deg"] for s in stats]))
    out = {
        "topic": topic,
        "n_scans": len(stats),
        "angle_pc1_z_deg_mean": round(pc1, 2),
        "angle_pc3_z_deg_mean": round(pc3, 2),
        "flatness_mean": round(float(np.mean([s["flatness"] for s in stats])), 4),
        "z_std_mean_m": round(float(np.mean([s["z_std"] for s in stats])), 3),
    }
    if normals:
        n_mean = np.mean(normals, axis=0)
        n_mean /= max(np.linalg.norm(n_mean), 1e-9)
        tilt = float(np.degrees(np.arccos(np.clip(n_mean[2], -1, 1))))
        out["ground_normal"] = [round(float(x), 4) for x in n_mean]
        out["ground_tilt_deg"] = round(tilt, 2)
    else:
        tilt = None

    # verdict: ground plane wins when available, PCA otherwise
    if tilt is not None:
        out["verdict"] = ("HORIZONTAL" if tilt < 10 else
                          "ANGLED" if tilt < 75 else "UNCLEAR")
    elif pc3 < 15:
        out["verdict"] = "HORIZONTAL"
    elif 30 < pc1 < 60:
        out["verdict"] = "ANGLED"
    else:
        out["verdict"] = "UNCLEAR"
    out["hint"] = {
        "HORIZONTAL": "T_base_lidar rotation [0,0,0] plausible",
        "ANGLED": "estimate T_base_lidar rotation "
                  "(python -m gcslam_torch.tools.estimate_extrinsics)",
        "UNCLEAR": "inspect scans manually; geometry too ambiguous for PCA",
    }[out["verdict"]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--topic", default=None)
    p.add_argument("--n-scans", type=int, default=10)
    p.add_argument("--skip", type=int, default=5)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = check_lidar_mount_angle(args.bag, args.topic, args.n_scans, args.skip)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
        return 0
    print(f"lidar mount angle  topic={info['topic']}  scans={info['n_scans']}")
    print(f"  PC1-Z {info['angle_pc1_z_deg_mean']} deg   "
          f"PC3-Z {info['angle_pc3_z_deg_mean']} deg   "
          f"flatness {info['flatness_mean']}")
    if "ground_tilt_deg" in info:
        print(f"  ground normal {info['ground_normal']}  "
              f"tilt {info['ground_tilt_deg']} deg")
    print(f"  verdict: {info['verdict']}  ({info['hint']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
