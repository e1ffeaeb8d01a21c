"""Trajectory-alignment forensics: which convention error explains est vs GT?

Folds three reference tools into one (tools/diagnose_trajectory_alignment.py
:246-297 axis-correlation mapping, tools/diagnose_trajectory_axes.py,
tools/generate_trajectory_comparison_swaps.py): when a first real-bag run
scores terribly, the cause is usually a frame-convention slip — swapped or
sign-flipped axes, an optical-vs-body frame, a yaw offset — not estimation.
This tool takes two TUM files and reports:

  1. per-trajectory stats (duration, path length, per-axis extent),
  2. the motion-delta correlation matrix est-axis x gt-axis and the implied
     best signed axis mapping,
  3. a brute-force search over all 48 signed axis permutations of est
     (24 proper rotations + 24 reflections), each scored by initial-aligned
     ATE — the best few are printed with their fix matrices; a reflection
     winning flags a handedness bug,
  4. the residual heading offset after the best mapping.

Usage:
  python -m gcslam_torch.tools.diagnose_trajectory_alignment est.tum gt.tum
         [--max-dt 0.1] [--json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np

from gcslam_torch.outputs.tum import read_tum


def _associate(t_a, t_b, max_dt):
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    j = np.where(np.abs(t_a - t_b[j - 1]) < np.abs(t_a - t_b[j]), j - 1, j)
    ok = np.abs(t_a - t_b[j]) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def _stats(t, p):
    d = np.linalg.norm(np.diff(p, axis=0), axis=1)
    return {
        "n": int(len(t)),
        "duration_s": round(float(t[-1] - t[0]), 2),
        "path_length_m": round(float(d.sum()), 2),
        "extent_m": [round(float(p[:, i].max() - p[:, i].min()), 3)
                     for i in range(3)],
    }


def _ate_initial(e, g):
    """ATE after removing the initial offset (translation only — rotation
    conventions are exactly what we are probing)."""
    return float(np.sqrt(((e - e[0] - (g - g[0])) ** 2).sum(1).mean()))


def _axis_correlation(e, g):
    de, dg = np.diff(e, axis=0), np.diff(g, axis=0)
    corr = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            if de[:, i].std() > 1e-9 and dg[:, j].std() > 1e-9:
                corr[i, j] = float(np.corrcoef(de[:, i], dg[:, j])[0, 1])
    names = "XYZ"
    mapping = {}
    for i in range(3):
        j = int(np.argmax(np.abs(corr[i])))
        mapping[f"est_{names[i]}"] = (
            f"{'+' if corr[i, j] >= 0 else '-'}gt_{names[j]} "
            f"(corr {corr[i, j]:+.3f})")
    return corr, mapping


def _signed_permutations():
    """All 48 signed 3x3 permutation matrices, tagged with det."""
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            M = np.zeros((3, 3))
            for i, (p, s) in enumerate(zip(perm, signs)):
                M[i, p] = s
            yield M


def diagnose_trajectory_alignment(est_path: str, gt_path: str,
                                  max_dt: float = 0.1) -> dict:
    t_e, pe = read_tum(est_path)
    t_g, pg = read_tum(gt_path)
    ie, ig = _associate(np.asarray(t_e), np.asarray(t_g), max_dt)
    if len(ie) < 10:
        return {"error": f"only {len(ie)} associated pairs — check the "
                         f"stamp units/offset first (compute_time_alignment)"}
    e, g = np.asarray(pe)[ie, :3], np.asarray(pg)[ig, :3]

    corr, mapping = _axis_correlation(e, g)

    results = []
    for M in _signed_permutations():
        ate = _ate_initial(e @ M.T, g)
        results.append((ate, M))
    results.sort(key=lambda r: r[0])
    identity_ate = _ate_initial(e, g)
    best = []
    for ate, M in results[:3]:
        best.append({
            "ate_m": round(ate, 4),
            "matrix": [[int(v) for v in row] for row in M],
            "proper_rotation": bool(np.linalg.det(M) > 0),
        })

    # residual planar heading offset after the best mapping
    eb = e @ results[0][1].T
    de, dg = np.diff(eb[:, :2], axis=0), np.diff(g[:, :2], axis=0)
    num = float((de[:, 0] * dg[:, 1] - de[:, 1] * dg[:, 0]).sum())
    den = float((de * dg).sum())
    yaw_off = float(np.degrees(np.arctan2(num, den)))

    win = best[0]
    is_identity = bool(np.array_equal(win["matrix"], np.eye(3, dtype=int)))
    verdict = (
        "CONVENTIONS_OK" if is_identity and abs(yaw_off) < 5 else
        "YAW_OFFSET" if is_identity else
        "AXIS_REMAP_NEEDED" if win["proper_rotation"] else
        "HANDEDNESS_FLIP (a reflection wins — sign bug, not a rotation)")
    return {
        "n_pairs": int(len(ie)),
        "est_stats": _stats(np.asarray(t_e)[ie], e),
        "gt_stats": _stats(np.asarray(t_g)[ig], g),
        "identity_ate_m": round(identity_ate, 4),
        "axis_correlation": [[round(v, 3) for v in row] for row in corr],
        "axis_mapping": mapping,
        "best_mappings": best,
        "residual_yaw_offset_deg": round(yaw_off, 2),
        "verdict": verdict,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--max-dt", type=float, default=0.1)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    info = diagnose_trajectory_alignment(args.est, args.gt, args.max_dt)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(info, indent=2))
        return 0 if info["verdict"] == "CONVENTIONS_OK" else 1
    print(f"trajectory alignment  pairs={info['n_pairs']}  "
          f"est path {info['est_stats']['path_length_m']} m / "
          f"gt path {info['gt_stats']['path_length_m']} m")
    print(f"  identity ATE {info['identity_ate_m']} m")
    for k, v in info["axis_mapping"].items():
        print(f"  {k} -> {v}")
    for b in info["best_mappings"]:
        kind = "rotation" if b["proper_rotation"] else "REFLECTION"
        print(f"  candidate {b['matrix']} ({kind}): ATE {b['ate_m']} m")
    print(f"  residual yaw offset after best mapping: "
          f"{info['residual_yaw_offset_deg']} deg")
    print(f"  verdict: {info['verdict']}")
    return 0 if info["verdict"] == "CONVENTIONS_OK" else 1


if __name__ == "__main__":
    sys.exit(main())
