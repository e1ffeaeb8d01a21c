"""Produce a per-stream time-alignment profile (offset + drift vs a
reference topic) from a rosbag2 sqlite bag — the profile the frontend
consumes via `frontend.time_alignment_path` (reference
tools/compute_time_alignment.py:1-122; same YAML schema and conventions:
offset sample = nearest-other-stamp - ref-stamp, offset = median, drift =
least-squares slope of offsets over (t - t0)).

Usage:
  python -m gcslam_torch.tools.compute_time_alignment <bag.db3> \
      --reference /acl_jackal/lidar_points \
      --topics /acl_jackal/forward/imu /acl_jackal/.../odom \
      --duration 60 --out profile.yaml
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def stream_stamps(raw: Dict, topic: str) -> np.ndarray:
    """Header stamps for every message on a topic (sorted)."""
    out = []
    for _, buf in raw.get(topic, []):
        try:
            out.append(cdr.header_stamp(buf))
        except Exception:
            continue
    return np.sort(np.asarray(out, dtype=np.float64))


def align_streams(
    ref_stamps: np.ndarray,
    other_stamps: np.ndarray,
    duration: Optional[float] = None,
) -> Optional[Dict[str, float]]:
    """-> {offset_sec, drift_sec_per_sec} or None when a stream is empty.

    For each reference stamp t, the offset sample is the nearest other-stream
    stamp minus t (the reference tool's convention, summarize() :36-48);
    offset = median of samples, drift = LS slope over (t - t_ref0)."""
    if len(ref_stamps) == 0 or len(other_stamps) == 0:
        return None
    t0 = float(ref_stamps[0])
    ref = ref_stamps
    if duration is not None:
        ref = ref[ref <= t0 + duration]
    if len(ref) == 0:
        return None
    idx = np.searchsorted(other_stamps, ref)
    lo = np.clip(idx - 1, 0, len(other_stamps) - 1)
    hi = np.clip(idx, 0, len(other_stamps) - 1)
    pick = np.where(
        np.abs(other_stamps[lo] - ref) <= np.abs(other_stamps[hi] - ref), lo, hi
    )
    offs = other_stamps[pick] - ref
    x = ref - t0
    slope = float(np.polyfit(x, offs, 1)[0]) if len(ref) >= 2 else 0.0
    return {"offset_sec": float(np.median(offs)), "drift_sec_per_sec": slope}


def compute_profile(
    bag_path: str,
    reference: str,
    topics: List[str],
    duration: float = 60.0,
) -> Dict:
    raw = rosbag.read_bag_messages(bag_path)
    raw.pop("__types__", None)
    ref_stamps = stream_stamps(raw, reference)
    if len(ref_stamps) == 0:
        raise ValueError(f"reference topic {reference!r} has no messages in {bag_path}")
    t0 = float(ref_stamps[0])
    streams = {}
    for t in topics:
        if t == reference:
            continue
        stats = align_streams(ref_stamps, stream_stamps(raw, t), duration)
        if stats is None:
            continue
        stats["t0_sec"] = t0
        streams[t] = stats
    return {
        "time_alignment": {
            "reference": reference,
            "window_sec": float(duration),
            "t0_sec": t0,
            "streams": streams,
        }
    }


def write_profile(profile: Dict, out_path: str) -> None:
    if out_path.endswith(".json"):
        with open(out_path, "w") as f:
            json.dump(profile, f, indent=2)
        return
    import yaml

    with open(out_path, "w") as f:
        yaml.safe_dump(profile, f, sort_keys=False)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("bag", help="rosbag2 .db3 path")
    p.add_argument("--reference", required=True)
    p.add_argument("--topics", nargs="+", required=True)
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument("--out", default=None, help="output YAML/JSON (default stdout)")
    args = p.parse_args(argv)
    profile = compute_profile(args.bag, args.reference, args.topics, args.duration)
    if args.out:
        write_profile(profile, args.out)
    else:
        print(json.dumps(profile, indent=2))
    return profile


if __name__ == "__main__":
    main()
