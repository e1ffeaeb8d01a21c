"""Bag forensics CLI — the inspect_*/diagnose_* toolbox analog
(reference tools/, ~25 scripts; SURVEY.md 2.9):

  python -m gcslam_torch.tools.bag_info path/to/bag.db3

Reports: topics/types/counts/rates, time spans, per-topic stamp offsets vs
the LiDAR clock (compute_time_alignment analog), PointCloud2 field layout,
IMU gravity magnitude + gravity-direction estimate, odom sanity (frame
convention / covariance diagonals), gravity-based extrinsic tilt estimate
(estimate_extrinsic-from-gravity analog).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag
from gcslam_torch.frontend.time_alignment import estimate_offset


def bag_info(db_path: str, max_msgs: int = 200) -> dict:
    raw = rosbag.read_bag_messages(db_path)
    types = raw.pop("__types__")
    info = {"path": db_path, "topics": {}}

    for name, msgs in raw.items():
        if not msgs:
            continue
        ts = np.asarray([t for t, _ in msgs])
        entry = {
            "type": types.get(name, "?"),
            "count": len(msgs),
            "t0": float(ts.min()),
            "t1": float(ts.max()),
            "rate_hz": float((len(ts) - 1) / max(ts.max() - ts.min(), 1e-9)) if len(ts) > 1 else 0.0,
        }
        typ = types.get(name, "")
        try:
            if "PointCloud2" in typ:
                m = cdr.parse_pointcloud2(msgs[0][1])
                entry["fields"] = [(f.name, f.offset, f.datatype) for f in m.fields]
                entry["point_step"] = m.point_step
                entry["points_per_msg"] = m.width * m.height
                entry["header_vs_bag_offset"] = m.header.stamp_sec - msgs[0][0]
            elif "Imu" in typ:
                sub = [cdr.parse_imu(b) for _, b in msgs[:max_msgs]]
                acc = np.stack([m.linear_acceleration for m in sub])
                gyr = np.stack([m.angular_velocity for m in sub])
                a_mag = float(np.linalg.norm(acc, axis=1).mean())
                entry["accel_mag_mean"] = a_mag
                entry["accel_units_guess"] = "g (scale by 9.81)" if 0.8 < a_mag < 1.2 else "m/s^2"
                g_dir = acc.mean(0) / max(np.linalg.norm(acc.mean(0)), 1e-9)
                entry["gravity_dir_body"] = [round(float(x), 4) for x in g_dir]
                # gravity-based tilt of the IMU vs world-up (extrinsic estimate)
                entry["tilt_from_up_deg"] = float(np.degrees(np.arccos(np.clip(g_dir[2], -1, 1))))
                entry["gyro_bias_guess"] = [round(float(x), 5) for x in gyr.mean(0)]
            elif "Odometry" in typ:
                sub = [cdr.parse_odometry(b) for _, b in msgs[:max_msgs]]
                pos = np.stack([m.position for m in sub])
                entry["frame_id"] = "?"
                entry["child_frame_id"] = sub[0].child_frame_id
                entry["pos_first"] = [round(float(x), 3) for x in pos[0]]
                entry["pos_span"] = [round(float(x), 3) for x in (pos.max(0) - pos.min(0))]
                entry["pose_cov_diag_first"] = [
                    round(float(x), 6) for x in np.asarray(sub[0].pose_cov).reshape(6, 6).diagonal()
                ]
        except Exception as e:  # forensics tool: report, never die
            entry["parse_error"] = str(e)
        info["topics"][name] = entry

    # per-topic offsets vs the LiDAR bag clock (compute_time_alignment analog)
    lidar = next((n for n, t in types.items() if "PointCloud2" in t and raw.get(n)), None)
    if lidar:
        t_l = np.asarray([t for t, _ in raw[lidar]])
        for name, msgs in raw.items():
            if name != lidar and msgs:
                t_o = np.asarray([t for t, _ in msgs])
                info["topics"][name]["offset_vs_lidar_sec"] = round(estimate_offset(t_l, t_o), 4)
    return info


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m gcslam_torch.tools.bag_info <bag.db3>")
        raise SystemExit(2)
    print(json.dumps(bag_info(args[0]), indent=2))


if __name__ == "__main__":
    main()
