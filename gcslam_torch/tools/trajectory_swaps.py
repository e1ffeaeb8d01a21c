"""Rank ground-truth axis permutations against an estimated trajectory.

Analog of reference tools/generate_trajectory_comparison_swaps.py (+ the
numeric core of plot_convention_fix.py): permute the GT axes (all 24 proper
rotations of the axis frame, optionally the 24 improper ones too), align at
the first pose, compute ATE per permutation, and print a ranked table. Used
to answer "which axis convention matches?" (e.g. "our Z = GT X") without
eyeballing 48 PNGs — the reference writes plots; this emits the ranking
numerically (JSON) since the decision variable is the ATE ordering itself.

Usage:
  python -m gcslam_torch.tools.trajectory_swaps est.tum gt.tum [--improper] [--top 8]
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np


def _perm_matrices(include_improper: bool = False):
    """All signed axis-permutation matrices; det=+1 unless include_improper."""
    out = []
    for perm in itertools.permutations(range(3)):
        P = np.zeros((3, 3))
        for i, j in enumerate(perm):
            P[i, j] = 1.0
        for signs in itertools.product((1.0, -1.0), repeat=3):
            M = P * np.asarray(signs)[:, None]
            if include_improper or np.linalg.det(M) > 0:
                out.append(M)
    return out


def _perm_name(M: np.ndarray) -> str:
    names = []
    for i in range(3):
        j = int(np.argmax(np.abs(M[i])))
        s = "-" if M[i, j] < 0 else "+"
        names.append(f"{'xyz'[i]}={s}{'xyz'[j]}")
    return ",".join(names)


def rank_swaps(est_tum: str, gt_tum: str, include_improper: bool = False) -> dict:
    from gcslam_torch.eval import ate_rpe
    from gcslam_torch.outputs.tum import read_tum

    est_s, est = read_tum(est_tum)
    gt_s, gt = read_tum(gt_tum)
    n = min(len(est_s), len(gt_s))
    est, gt = est[:n], gt[:n]

    rows = []
    for M in _perm_matrices(include_improper):
        gt_p = gt.copy()
        gt_p[:, :3] = gt[:, :3] @ M.T
        # rotation column: conjugate the rotvec direction (proper rotations
        # transform rotvecs linearly; improper ones flip handedness — the
        # resulting rot-ATE is reported but marked).
        gt_p[:, 3:6] = gt[:, 3:6] @ (M * np.linalg.det(M)).T
        ate = ate_rpe.compute_ate(est, gt_p, align="initial")
        rows.append({
            "perm": _perm_name(M),
            "proper": bool(np.linalg.det(M) > 0),
            "ate_trans_rmse_m": round(ate["translation"]["rmse"], 4),
            "ate_rot_rmse_deg": round(ate["rotation_deg"]["rmse"], 2),
        })
    rows.sort(key=lambda r: r["ate_trans_rmse_m"])
    identity = next(r for r in rows if r["perm"] == "x=+x,y=+y,z=+z")
    return {
        "est": est_tum,
        "gt": gt_tum,
        "n_poses": int(n),
        "best": rows[0],
        "identity": identity,
        "identity_is_best": rows[0]["perm"] == "x=+x,y=+y,z=+z",
        "ranking": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("est_tum")
    ap.add_argument("gt_tum")
    ap.add_argument("--improper", action="store_true",
                    help="include det=-1 (handedness-flipping) permutations")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    rep = rank_swaps(args.est_tum, args.gt_tum, args.improper)
    print(json.dumps({**rep, "ranking": rep["ranking"][: args.top]}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
