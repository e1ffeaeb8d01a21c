"""Deep rosbag2 inspector — surface *everything that can bite* an eval run.

The reference's inspect_rosbag_deep.py (tools/, 434 LoC), on the in-repo CDR
reader (no rclpy):

  - all topics: type, serialization format, offered QoS, message count,
    time range, mean rate;
  - per-topic stamp health: monotonicity violations, duplicate stamps,
    largest gap (sensor dropouts), header-stamp vs bag-receive-time offset;
  - sensor specifics: PointCloud2 field layout / point counts / frame_ids,
    Image encodings/dimensions, Imu gravity magnitude, Odometry frames;
  - warnings: multiple frame_ids on one topic, zero-message topics, rate
    far from nominal (VLP-16 ~10 Hz, IMU 100-500 Hz), stamp offsets > 0.5 s;
  - --json for CI/automation.

Usage:
  python -m gcslam_torch.tools.inspect_bag_deep bag.db3 [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sqlite3
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _stamp_health(ts: np.ndarray) -> dict:
    d = np.diff(ts)
    return {
        "monotonic": bool(np.all(d >= 0)),
        "n_backwards": int(np.sum(d < 0)),
        "n_duplicate_stamps": int(np.sum(d == 0)),
        "largest_gap_s": round(float(d.max()), 4) if d.size else 0.0,
        "median_dt_s": round(float(np.median(d)), 6) if d.size else 0.0,
    }


def inspect_bag_deep(path: str, max_decode: int = 50) -> dict:
    raw = rosbag.read_bag_messages(path)
    types = raw.pop("__types__")
    out: dict = {"path": path, "topics": {}, "warnings": []}

    # topic metadata straight from the container (serialization format + QoS)
    meta: dict = {}
    if path.endswith(".db3"):
        conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        try:
            for name, typ, fmt, qos in conn.execute(
                "SELECT name, type, serialization_format, offered_qos_profiles FROM topics"
            ):
                meta[name] = {"serialization_format": fmt,
                              "offered_qos": (qos or "")[:200]}
        except sqlite3.OperationalError:
            pass
        finally:
            conn.close()

    for name, msgs in sorted(raw.items()):
        typ = types.get(name, "?")
        entry: dict = {"type": typ, "count": len(msgs)}
        entry.update(meta.get(name, {}))
        if not msgs:
            out["warnings"].append(f"{name}: declared but has ZERO messages")
            out["topics"][name] = entry
            continue
        ts = np.asarray([t for t, _ in msgs])
        entry["t0"], entry["t1"] = float(ts[0]), float(ts[-1])
        entry["rate_hz"] = round((len(ts) - 1) / max(ts[-1] - ts[0], 1e-9), 2) if len(ts) > 1 else 0.0
        entry["stamps"] = _stamp_health(ts)
        if not entry["stamps"]["monotonic"]:
            out["warnings"].append(f"{name}: NON-MONOTONIC bag timestamps "
                                   f"({entry['stamps']['n_backwards']} backwards)")

        frame_ids, hdr_offsets = set(), []
        try:
            if "PointCloud2" in typ:
                for _, b in msgs[:max_decode]:
                    m = cdr.parse_pointcloud2(b)
                    frame_ids.add(m.header.frame_id)
                    hdr_offsets.append(m.header.stamp_sec)
                m0 = cdr.parse_pointcloud2(msgs[0][1])
                entry["fields"] = [(f.name, f.offset, f.datatype, f.count) for f in m0.fields]
                entry["point_step"] = m0.point_step
                entry["points_per_msg"] = m0.width * m0.height
                entry["is_dense"] = bool(m0.is_dense)
                if not (5.0 < entry["rate_hz"] < 25.0):
                    out["warnings"].append(
                        f"{name}: LiDAR rate {entry['rate_hz']} Hz outside 5-25 Hz")
            elif typ.endswith("/Imu"):
                accs = []
                for _, b in msgs[:max_decode]:
                    m = cdr.parse_imu(b)
                    frame_ids.add(m.header.frame_id)
                    hdr_offsets.append(m.header.stamp_sec)
                    accs.append(m.linear_acceleration)
                a_mag = float(np.linalg.norm(np.mean(accs, axis=0)))
                entry["accel_mag_mean"] = round(a_mag, 3)
                if not (50.0 < entry["rate_hz"] < 1000.0):
                    out["warnings"].append(
                        f"{name}: IMU rate {entry['rate_hz']} Hz outside 50-1000 Hz")
                if not (0.8 < a_mag < 1.2 or 8.0 < a_mag < 11.5):
                    out["warnings"].append(
                        f"{name}: |accel| mean {a_mag:.2f} is neither ~1 g nor ~9.81 m/s^2")
            elif "Odometry" in typ:
                for _, b in msgs[:max_decode]:
                    m = cdr.parse_odometry(b)
                    frame_ids.add(m.child_frame_id)
                    hdr_offsets.append(m.header.stamp_sec)
                entry["child_frame_id"] = sorted(frame_ids)
            elif "CompressedImage" in typ:
                m = cdr.parse_compressed_image(msgs[0][1])
                entry["format"] = m.format
                frame_ids.add(m.header.frame_id)
                hdr_offsets.append(m.header.stamp_sec)
            elif typ.endswith("/Image"):
                m = cdr.parse_image(msgs[0][1])
                entry["encoding"] = m.encoding
                entry["dims"] = [m.height, m.width]
                frame_ids.add(m.header.frame_id)
                hdr_offsets.append(m.header.stamp_sec)
        except Exception as e:  # forensics tool: report, never die
            entry["decode_error"] = str(e)

        if frame_ids:
            entry["frame_ids"] = sorted(frame_ids)
            if len(frame_ids) > 1:
                out["warnings"].append(f"{name}: MULTIPLE frame_ids {sorted(frame_ids)}")
        if hdr_offsets:
            off = float(np.mean(np.asarray(hdr_offsets) - ts[: len(hdr_offsets)]))
            entry["header_vs_bag_time_s"] = round(off, 4)
            if abs(off) > 0.5:
                out["warnings"].append(
                    f"{name}: header stamps differ from bag receive time by {off:.2f} s "
                    "— run compute_time_alignment before evaluating")
        out["topics"][name] = entry

    has = {k: any(k in t for t in types.values())
           for k in ("PointCloud2", "Imu", "Odometry")}
    for k, present in has.items():
        if not present:
            out["warnings"].append(f"bag has NO {k} topic — pipeline input missing")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the summary JSON here")
    args = ap.parse_args(argv)
    info = inspect_bag_deep(args.bag)
    print(json.dumps(info, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(info, f, indent=2)
    return 0 if not any("NO " in w for w in info["warnings"]) else 1


if __name__ == "__main__":
    sys.exit(main())
