"""Planar (2D) trajectory evaluation: SE(2) alignment + XY ATE / yaw error.

The reference's tools/evaluate_trajectory_2d.py:1-421: for planar robots the
odometry/GT z channel is meaningless (wheel odometry never measures it), so
a fair score projects both trajectories into the XY plane, aligns with an
SE(2) transform (planar rotation + translation, closed-form 2D Umeyama) and
reports 2D ATE plus heading (yaw) error and 2D RPE. Inputs are TUM files
(ours: results/<run>/trajectory.tum + ground_truth.tum), with stamp-based
association for differently-sampled files.

--plot writes the XY view (ground truth solid, the SE(2)-aligned estimate
dashed, equal axes) as an SVG (outputs/svg_plot.py; the GPU hosts have no
matplotlib); it takes a .svg path, and any other suffix raises.

Usage:
  python -m gcslam_torch.tools.evaluate_trajectory_2d est.tum gt.tum
         [--rpe-delta 1.0] [--plot out.svg] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from gcslam_torch.outputs.tum import read_tum


def _yaw_from_rotvec(rv: np.ndarray) -> np.ndarray:
    """Heading of each rotvec: yaw of the rotation matrix (ZYX convention)."""
    from gcslam_torch.eval.ate_rpe import _rotvec_to_R

    return np.asarray([np.arctan2(R[1, 0], R[0, 0])
                       for R in (_rotvec_to_R(r) for r in rv)])


def _associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.05):
    """Nearest-stamp association a->b; returns index pairs within max_dt."""
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    left, right = t_b[j - 1], t_b[j]
    j = np.where(np.abs(t_a - left) < np.abs(t_a - right), j - 1, j)
    ok = np.abs(t_a - t_b[j]) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def _se2_umeyama(est_xy: np.ndarray, gt_xy: np.ndarray):
    """Closed-form planar alignment: rotation theta + translation minimizing
    ||gt - (R est + t)||^2."""
    mu_e, mu_g = est_xy.mean(0), gt_xy.mean(0)
    e, g = est_xy - mu_e, gt_xy - mu_g
    # 2D Kabsch: theta = atan2(sum(e x g), sum(e . g))
    cross = float((e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0]).sum())
    dot = float((e * g).sum())
    theta = np.arctan2(cross, dot)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    t = mu_g - R @ mu_e
    return R, t, theta


def _stats(err: np.ndarray) -> dict:
    return {"rmse": float(np.sqrt((err ** 2).mean())), "mean": float(err.mean()),
            "median": float(np.median(err)), "max": float(err.max())}


def evaluate_trajectory_2d(est_path: str, gt_path: str,
                           rpe_delta_m: float = 1.0,
                           max_dt: float = 0.05) -> dict:
    t_e, poses_e = read_tum(est_path)
    t_g, poses_g = read_tum(gt_path)
    ie, ig = _associate(np.asarray(t_e), np.asarray(t_g), max_dt)
    if len(ie) < 3:
        return {"error": f"only {len(ie)} associated pairs (max_dt={max_dt})"}

    e_xy = np.asarray(poses_e)[ie, :2]
    g_xy = np.asarray(poses_g)[ig, :2]
    yaw_e = _yaw_from_rotvec(np.asarray(poses_e)[ie, 3:6])
    yaw_g = _yaw_from_rotvec(np.asarray(poses_g)[ig, 3:6])

    R, t, theta = _se2_umeyama(e_xy, g_xy)
    e_al = e_xy @ R.T + t

    ate2d = np.linalg.norm(e_al - g_xy, axis=1)
    dyaw = np.degrees(np.abs(np.arctan2(
        np.sin(yaw_e + theta - yaw_g), np.cos(yaw_e + theta - yaw_g))))

    # 2D RPE at a distance delta: pairs (i, j) with path length ~ delta
    seg = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(g_xy, axis=0), axis=1))])
    pairs = []
    j = 0
    for i in range(len(seg)):
        while j < len(seg) and seg[j] - seg[i] < rpe_delta_m:
            j += 1
        if j < len(seg):
            pairs.append((i, j))
    rpe = []
    for i, j2 in pairs:
        d_est = e_al[j2] - e_al[i]
        d_gt = g_xy[j2] - g_xy[i]
        rpe.append(np.linalg.norm(d_est - d_gt))
    out = {
        "n_pairs": int(len(ie)),
        "align": {"theta_deg": round(float(np.degrees(theta)), 3),
                  "t": [round(float(x), 4) for x in t]},
        "ate_2d": {k: round(v, 4) for k, v in _stats(ate2d).items()},
        "yaw_deg": {k: round(v, 3) for k, v in _stats(dyaw).items()},
        "rpe_2d_at_delta": ({k: round(v, 4) for k, v in _stats(np.asarray(rpe)).items()}
                            if rpe else None),
        "rpe_delta_m": rpe_delta_m,
        "path_length_m": round(float(seg[-1]), 2),
    }
    out["_plotdata"] = (e_al, g_xy)  # stripped before JSON emit
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--rpe-delta", type=float, default=1.0)
    p.add_argument("--max-dt", type=float, default=0.05)
    p.add_argument("--plot", default=None, metavar="OUT.svg")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    from gcslam_torch.outputs import svg_plot as sp

    if args.plot:
        sp.check_svg_path(args.plot)

    info = evaluate_trajectory_2d(args.est, args.gt, args.rpe_delta, args.max_dt)
    if "error" in info:
        print(json.dumps(info, indent=2), file=sys.stderr)
        return 1
    e_al, g_xy = info.pop("_plotdata")
    if args.plot:
        sp.write_figure(args.plot, [sp.panel(
            f"2D ATE rmse {info['ate_2d']['rmse']:.3f} m",
            [sp.Line(g_xy[:, 0], g_xy[:, 1], "ground truth"),
             sp.Line(e_al[:, 0], e_al[:, 1], "estimate (SE2-aligned)", dashed=True)],
            w=720, h=560, xlabel="x [m]", ylabel="y [m]", equal_aspect=True)], w=720, h=560)
        print(f"wrote {args.plot}", file=sys.stderr)
    if args.json:
        print(json.dumps(info, indent=2))
        return 0
    print(f"2D evaluation  pairs={info['n_pairs']}  "
          f"path {info['path_length_m']} m  "
          f"SE2 align theta={info['align']['theta_deg']} deg t={info['align']['t']}")
    print(f"  ATE-2D  rmse {info['ate_2d']['rmse']} m  "
          f"median {info['ate_2d']['median']} m  max {info['ate_2d']['max']} m")
    print(f"  yaw     rmse {info['yaw_deg']['rmse']} deg  "
          f"median {info['yaw_deg']['median']} deg")
    if info["rpe_2d_at_delta"]:
        print(f"  RPE-2D@{info['rpe_delta_m']}m  "
              f"rmse {info['rpe_2d_at_delta']['rmse']} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
