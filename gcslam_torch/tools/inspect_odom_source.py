"""Odometry-source forensics: wheel-only vs fused, frames, rates, twist health.

The reference's tools/inspect_odom_source.py (dumps the first odom messages
to judge whether /odom is wheel-only or IMU-fused) plus the rate/frame
summary its other odom scripts repeat. Heuristics reported:

  - header.frame_id / child_frame_id (the pipeline expects odom->base)
  - message rate (median inter-stamp gap)
  - twist present? (all-zero twist => pose-only odometry; the velocity /
    yaw-rate evidence operators would be feeding on zeros)
  - z channel live? (flat z + huge z variance = planar wheel odometry;
    the reference floors odom z-variance at 1e6, backend_node.py:1523)
  - orientation quality: unit-norm quaternions, yaw-only vs full 3D
  - wheel-only signature: pose_cov constant AND twist_cov constant AND
    z flat => almost certainly wheel/encoder integration, not a filter

Usage:
  python -m gcslam_torch.tools.inspect_odom_source bag.db3 [--topic /odom]
         [--max 2000] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def inspect_odom_source(bag_path: str, topic: str | None = None,
                        max_msgs: int = 2000) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    if topic is None:
        topic = next((n for n, t in types.items()
                      if "Odometry" in t and raw.get(n)), None)
    if topic is None or not raw.get(topic):
        return {"error": f"no Odometry topic found in {bag_path}",
                "topics": dict(types)}

    msgs = [cdr.parse_odometry(b) for _, b in raw[topic][:max_msgs]]
    t = np.asarray([m.header.stamp_sec for m in msgs])
    pos = np.stack([m.position for m in msgs])
    quat = np.stack([m.orientation for m in msgs])
    tl = np.stack([m.twist_linear for m in msgs])
    ta = np.stack([m.twist_angular for m in msgs])
    pcov = np.stack([m.pose_cov for m in msgs])
    tcov = np.stack([m.twist_cov for m in msgs])

    dt = np.diff(t)
    rate_hz = float(1.0 / np.median(dt)) if len(dt) and np.median(dt) > 0 else 0.0

    qnorm = np.linalg.norm(quat, axis=1)
    # yaw-only: x,y quaternion components ~0 throughout
    yaw_only = bool(np.abs(quat[:, :2]).max() < 1e-6)
    z_span = float(pos[:, 2].max() - pos[:, 2].min())
    z_flat = bool(z_span < 1e-6)
    twist_dead = bool(np.abs(tl).max() < 1e-12 and np.abs(ta).max() < 1e-12)
    pose_cov_fixed = bool(np.abs(pcov - pcov[0]).max() < 1e-15)
    twist_cov_fixed = bool(np.abs(tcov - tcov[0]).max() < 1e-15)
    z_var = float(np.median(pcov[:, 14]))  # row 2, col 2 of 6x6

    wheel_only = pose_cov_fixed and twist_cov_fixed and z_flat
    verdict = ("POSE_ONLY (twist dead)" if twist_dead else
               "WHEEL_ONLY (fixed covs, flat z)" if wheel_only else
               "LIKELY_FUSED (covariance or z varies)")

    return {
        "topic": topic,
        "n_sampled": len(msgs),
        "frame_id": msgs[0].header.frame_id,
        "child_frame_id": msgs[0].child_frame_id,
        "rate_hz": round(rate_hz, 2),
        "quat_unit_norm": bool(np.abs(qnorm - 1.0).max() < 1e-6),
        "yaw_only": yaw_only,
        "z_span_m": round(z_span, 6),
        "z_variance_median": z_var,
        "z_variance_floored_needed": bool(z_var < 1e-3),
        "twist_dead": twist_dead,
        "pose_cov_fixed": pose_cov_fixed,
        "twist_cov_fixed": twist_cov_fixed,
        "speed_max_mps": round(float(np.linalg.norm(tl, axis=1).max()), 4),
        "yawrate_max": round(float(np.abs(ta[:, 2]).max()), 4),
        "verdict": verdict,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bag")
    p.add_argument("--topic", default=None)
    p.add_argument("--max", type=int, default=2000)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = inspect_odom_source(args.bag, args.topic, args.max)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
        return 0
    print(f"odom source  topic={info['topic']}  "
          f"{info['frame_id']} -> {info['child_frame_id']}  {info['rate_hz']} Hz")
    print(f"  quat unit: {info['quat_unit_norm']}  yaw-only: {info['yaw_only']}  "
          f"z span: {info['z_span_m']} m  z var: {info['z_variance_median']:.2e}"
          f"{'  (floor needed)' if info['z_variance_floored_needed'] else ''}")
    print(f"  twist dead: {info['twist_dead']}  pose_cov fixed: {info['pose_cov_fixed']}  "
          f"twist_cov fixed: {info['twist_cov_fixed']}")
    print(f"  max speed {info['speed_max_mps']} m/s  max |wz| {info['yawrate_max']} rad/s")
    print(f"  verdict: {info['verdict']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
