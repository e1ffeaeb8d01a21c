"""First-N-messages summary for every (or selected) topic in a bag.

The reference's tools/first_n_messages_summary.py:1-199: per topic, emit the
frame_id, stamps, and sample field values of the first N messages — the
fastest way to check field names / frames / units across bags before a run.
PointCloud2 shows the field table + first-point sample; Imu/Odometry show
raw vectors; unknown types fall back to byte length.

Usage:
  python -m gcslam_torch.tools.first_n_messages_summary bag.db3
         [--n 3] [--topics /odom /imu/data] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _f(x):
    return [round(float(v), 6) for v in np.asarray(x).ravel()]


def _sample(typ: str, buf: bytes) -> dict:
    if "PointCloud2" in typ:
        m = cdr.parse_pointcloud2(buf)
        xyz, pt_t, ring, _ = cdr.pointcloud2_to_arrays(m)
        return {
            "frame_id": m.header.frame_id,
            "stamp_sec": m.header.stamp_sec,
            "width": m.width, "height": m.height,
            "point_step": m.point_step, "is_dense": m.is_dense,
            "fields": [{"name": f.name, "offset": f.offset,
                        "datatype": f.datatype} for f in m.fields],
            "first_point_xyz": _f(xyz[0]) if len(xyz) else None,
            "rel_time_span_s": (round(float(pt_t.max() - pt_t.min()), 4)
                                if len(pt_t) else None),
            "ring_range": ([int(ring.min()), int(ring.max())]
                           if len(ring) else None),
        }
    if "Imu" in typ:
        m = cdr.parse_imu(buf)
        return {"frame_id": m.header.frame_id, "stamp_sec": m.header.stamp_sec,
                "angular_velocity": _f(m.angular_velocity),
                "linear_acceleration": _f(m.linear_acceleration),
                "orientation_xyzw": _f(m.orientation)}
    if "Odometry" in typ:
        m = cdr.parse_odometry(buf)
        return {"frame_id": m.header.frame_id,
                "child_frame_id": m.child_frame_id,
                "stamp_sec": m.header.stamp_sec,
                "position": _f(m.position), "orientation_xyzw": _f(m.orientation),
                "twist_linear": _f(m.twist_linear),
                "twist_angular": _f(m.twist_angular),
                "pose_cov_diag": _f(np.asarray(m.pose_cov).reshape(6, 6).diagonal())}
    if "CompressedImage" in typ or "Image" in typ:
        try:
            m = cdr.parse_compressed_image(buf) if "Compressed" in typ \
                else cdr.parse_image(buf)
            return {"frame_id": m.header.frame_id,
                    "stamp_sec": m.header.stamp_sec,
                    "format": getattr(m, "format", getattr(m, "encoding", "?")),
                    "bytes": len(getattr(m, "data", b""))}
        except Exception as e:
            return {"parse_error": str(e)[:120], "bytes": len(buf)}
    return {"bytes": len(buf)}


def first_n_messages_summary(bag_path: str, n: int = 3, topics=None) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    sel = topics or sorted(types)
    out = {"bag": bag_path, "topics": {}}
    for name in sel:
        msgs = raw.get(name, [])
        entry = {"type": types.get(name, "?"), "count": len(msgs),
                 "messages": []}
        for bag_t, buf in msgs[:n]:
            try:
                s = _sample(types.get(name, ""), buf)
            except Exception as e:
                s = {"parse_error": str(e)[:120], "bytes": len(buf)}
            s["bag_sec"] = round(float(bag_t), 9)
            entry["messages"].append(s)
        out["topics"][name] = entry
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--topics", nargs="*", default=None)
    p.add_argument("--json", default=None, metavar="OUT.json")
    args = p.parse_args(argv)

    info = first_n_messages_summary(args.bag, args.n, args.topics)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(info, f, indent=2)
        print(f"wrote {args.json}")
        return 0
    for name, e in info["topics"].items():
        print(f"## {name}  ({e['type']}, {e['count']} msgs)")
        for i, m in enumerate(e["messages"]):
            print(f"  [{i}] " + json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
