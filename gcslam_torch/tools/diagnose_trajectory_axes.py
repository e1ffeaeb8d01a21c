"""Diagnose "motion in the wrong axis" between bag odometry and exported TUM.

Analog of reference tools/diagnose_trajectory_axes.py: if the bag's odometry
moves mainly in XY (planar robot) but the exported trajectory moves mainly in
Z (or any other axis), an axis/frame convention is wrong in the pipeline.
Reports per-axis spans for both, the dominant axes, and — when both sources
are given — the best axis correlation assignment between odom and TUM
displacement profiles.

Usage:
  python -m gcslam_torch.tools.diagnose_trajectory_axes bag.db3 [traj.tum] [--json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from gcslam_torch.frontend import cdr, rosbag


def _axis_stats(p: np.ndarray) -> dict:
    span = p.max(axis=0) - p.min(axis=0)
    order = np.argsort(-span)
    return {
        "span_xyz_m": [float(v) for v in span],
        "dominant_axis": "xyz"[int(order[0])],
        "planar_xy": bool(span[2] < 0.25 * max(float(span[:2].max()), 1e-9)),
    }


def diagnose_trajectory_axes(
    bag_path: str, tum_path: str | None = None, max_odom: int = 500
) -> dict:
    raw = rosbag.read_bag_messages(bag_path)
    types = raw.pop("__types__")
    out: dict = {"bag": bag_path}

    odom_topic = next((n for n, t in types.items() if "Odometry" in t and raw.get(n)), None)
    odom_p = odom_t = None
    if odom_topic:
        odoms = [cdr.parse_odometry(b) for _, b in raw[odom_topic][:max_odom]]
        odom_p = np.array([m.position for m in odoms])
        odom_t = np.array([m.header.stamp_sec for m in odoms])
        out["odom"] = {"topic": odom_topic, "n": len(odoms), **_axis_stats(odom_p)}

    if tum_path:
        from gcslam_torch.outputs.tum import read_tum

        stamps, poses = read_tum(tum_path)
        tum_p = poses[:, :3]
        out["tum"] = {"path": tum_path, "n": int(len(stamps)), **_axis_stats(tum_p)}

        if odom_p is not None and len(odom_p) > 2 and len(stamps) > 2:
            # resample odom displacement onto TUM stamps, correlate each
            # odom axis against each TUM axis -> best |corr| assignment
            t0, t1 = max(odom_t[0], stamps[0]), min(odom_t[-1], stamps[-1])
            sel = (stamps >= t0) & (stamps <= t1)
            C = np.zeros((3, 3))
            if sel.sum() > 3 and t1 > t0:
                for i in range(3):
                    oi = np.interp(stamps[sel], odom_t, odom_p[:, i])
                    for j in range(3):
                        tj = tum_p[sel, j]
                        so, st = np.std(oi), np.std(tj)
                        if so > 1e-9 and st > 1e-9:
                            C[i, j] = np.corrcoef(oi, tj)[0, 1]
            # one-to-one greedy assignment by |corr| (argmax-per-row breaks
            # on collinear axes); axes with no correlation evidence (zero
            # variance in either source) keep their identity mapping.
            A = np.abs(C.copy())
            assign = [-1, -1, -1]
            for _ in range(3):
                i, j = np.unravel_index(int(np.argmax(A)), A.shape)
                if A[i, j] < 0.3:
                    break
                assign[i] = int(j)
                A[i, :] = -1.0
                A[:, j] = -1.0
            taken = {j for j in assign if j >= 0}
            for i in range(3):
                if assign[i] < 0:
                    assign[i] = i if i not in taken else int(
                        next(j for j in range(3) if j not in taken))
                    taken.add(assign[i])
            out["axis_correlation"] = {
                "matrix": [[round(float(v), 3) for v in row] for row in C],
                "best_assignment": {"xyz"[i]: "xyz"[assign[i]] for i in range(3)},
                "identity_mapping": bool(assign == [0, 1, 2]),
            }
            out["verdict"] = (
                "OK: odom and trajectory axes agree"
                if assign == [0, 1, 2]
                else "AXIS MISMATCH: odom axis -> trajectory axis mapping is "
                + json.dumps({"xyz"[i]: "xyz"[assign[i]] for i in range(3)})
            )
    if "verdict" not in out and odom_p is not None and tum_path:
        out["verdict"] = "insufficient overlap to correlate"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("tum", nargs="?", default=None)
    ap.add_argument("--max-odom", type=int, default=500)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rep = diagnose_trajectory_axes(args.bag, args.tum, args.max_odom)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        for k, v in rep.items():
            print(f"{k}: {json.dumps(v)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
