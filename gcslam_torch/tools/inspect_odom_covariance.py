"""Odometry covariance forensics: FIXED vs VARIES across messages.

The reference's first-real-bag derisking tool (tools/inspect_odom_covariance.py:
1-124): a bag whose odom covariance never changes is a bag whose covariance is
a config constant, not an estimate — the pipeline's odom evidence should then
be interpreted (and possibly inflated) accordingly. Reads the first N odom
messages off the CDR reader (no ROS) and reports:

  - FIXED (identical for all sampled messages) with the 6 diagonal entries, or
  - VARIES with the first differing message index/stamp and both diagonals;
  - z/yaw variance floors (the reference floors odom z-variance at 1e6,
    backend_node.py:1523 — a 0 or tiny z variance here is what that guards);
  - optional full 36-value CSV dump for offline inspection.

Usage:
  python -m gcslam_torch.tools.inspect_odom_covariance bag.db3 [--topic /odom]
         [--max 500] [--dump-csv out.csv] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def inspect_odom_covariance(db_path: str, topic: str | None = None, max_msgs: int = 500) -> dict:
    raw = rosbag.read_bag_messages(db_path)
    types = raw.pop("__types__")
    if topic is None:
        topic = next((n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    if topic is None or not raw.get(topic):
        return {"error": f"no Odometry topic found in {db_path}", "topics": list(types)}

    msgs = [(t, cdr.parse_odometry(b)) for t, b in raw[topic][:max_msgs]]
    covs = np.stack([np.asarray(m.pose_cov, dtype=np.float64) for _, m in msgs])  # (N, 36)
    diag_idx = [0, 7, 14, 21, 28, 35]
    first = covs[0]
    same = np.all(covs == first[None, :], axis=1)  # (N,)
    all_same = bool(np.all(same))

    out = {
        "topic": topic,
        "n_sampled": len(msgs),
        "result": "FIXED" if all_same else "VARIES",
        "diag_first": [float(first[i]) for i in diag_idx],
        "diag_labels": ["x", "y", "z", "roll", "pitch", "yaw"],
    }
    if not all_same:
        k = int(np.argmin(same))
        out["first_differing_index"] = k
        out["first_differing_stamp"] = float(msgs[k][0])
        out["diag_at_first_diff"] = [float(covs[k][i]) for i in diag_idx]
        out["diag_min"] = [float(covs[:, i].min()) for i in diag_idx]
        out["diag_max"] = [float(covs[:, i].max()) for i in diag_idx]
    # floors the pipeline would apply (reference z-variance floor 1e6)
    out["z_variance_suspicious"] = bool(first[14] < 1e-6)
    out["twist_cov_diag_first"] = [
        float(np.asarray(msgs[0][1].twist_cov, dtype=np.float64)[i]) for i in diag_idx
    ]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag", help="rosbag2 .db3/.mcap path")
    ap.add_argument("--topic", default=None)
    ap.add_argument("--max", type=int, default=500)
    ap.add_argument("--dump-csv", default=None, metavar="PATH")
    ap.add_argument("--json", action="store_true", help="JSON output (default: text)")
    args = ap.parse_args(argv)

    info = inspect_odom_covariance(args.bag, args.topic, args.max)
    if "error" in info:
        print(json.dumps(info), file=sys.stderr)
        return 1

    if args.dump_csv:
        raw = rosbag.read_bag_messages(args.bag)
        raw.pop("__types__")
        with open(args.dump_csv, "w") as f:
            f.write("stamp_sec," + ",".join(f"cov_{i}" for i in range(36)) + "\n")
            for t, b in raw[info["topic"]][: args.max]:
                m = cdr.parse_odometry(b)
                f.write(f"{t:.9f}," + ",".join(str(float(x)) for x in m.pose_cov) + "\n")
        info["csv"] = args.dump_csv

    if args.json:
        print(json.dumps(info, indent=2))
    else:
        print(f"RESULT: pose covariance is {info['result']} "
              f"({info['n_sampled']} messages on {info['topic']})")
        for lbl, v in zip(info["diag_labels"], info["diag_first"]):
            print(f"  diag[{lbl}] = {v}")
        if info["result"] == "VARIES":
            print(f"  first differing message: index {info['first_differing_index']}, "
                  f"stamp={info['first_differing_stamp']:.6f}")
            print(f"  diag range min={info['diag_min']} max={info['diag_max']}")
        if info["z_variance_suspicious"]:
            print("  WARNING: z variance ~0 — the pipeline floors odom z-variance "
                  "(reference backend_node.py:1523); planar bag suspected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
