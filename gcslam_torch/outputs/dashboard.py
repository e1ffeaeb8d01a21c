"""Run dashboard (counterpart of the JAX package's outputs/dashboard.py):
trajectory, certificate sentinels and map stats as one HTML page, with the
same panels and titles. The panels are inline SVG drawn from numpy, so the
page needs no plotting package (the GPU hosts the port runs on have no
matplotlib)."""

from __future__ import annotations

import html
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcslam_torch.ops.certs import TRIGGER_NAMES, TRIGGERS

_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b"]
_PAD_L, _PAD_R, _PAD_T, _PAD_B = 64, 150, 26, 34


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def _axes(title: str, w: int, h: int, x0: float, x1: float, y0: float, y1: float,
          xlabel: str = "", ylabel: str = "") -> List[str]:
    """SVG header, frame, title and the axis range labels of one panel."""
    pw, ph = w - _PAD_L - _PAD_R, h - _PAD_T - _PAD_B
    return [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" font-family="sans-serif" font-size="10">',
        f'<rect x="{_PAD_L}" y="{_PAD_T}" width="{pw}" height="{ph}" fill="none" stroke="#444"/>',
        f'<text x="{_PAD_L + pw / 2}" y="16" text-anchor="middle" font-size="12">{html.escape(title)}</text>',
        f'<text x="{_PAD_L}" y="{h - 18}" text-anchor="middle">{_fmt(x0)}</text>',
        f'<text x="{_PAD_L + pw}" y="{h - 18}" text-anchor="middle">{_fmt(x1)}</text>',
        f'<text x="{_PAD_L + pw / 2}" y="{h - 4}" text-anchor="middle">{html.escape(xlabel)}</text>',
        f'<text x="{_PAD_L - 4}" y="{_PAD_T + ph}" text-anchor="end">{_fmt(y0)}</text>',
        f'<text x="{_PAD_L - 4}" y="{_PAD_T + 8}" text-anchor="end">{_fmt(y1)}</text>',
        f'<text x="12" y="{_PAD_T + ph / 2}" transform="rotate(-90 12 {_PAD_T + ph / 2})" '
        f'text-anchor="middle">{html.escape(ylabel)}</text>',
    ]


def _range(vals: Sequence[np.ndarray]) -> Tuple[float, float]:
    finite = [v[np.isfinite(v)] for v in vals]
    finite = [v for v in finite if v.size]
    if not finite:
        return 0.0, 1.0
    lo, hi = min(float(v.min()) for v in finite), max(float(v.max()) for v in finite)
    return (lo - 0.5, hi + 0.5) if hi - lo < 1e-12 else (lo, hi)


def line_panel(title: str, x, series: Sequence[Tuple[str, np.ndarray]], w: int = 800, h: int = 240,
               xlabel: str = "", ylabel: str = "", equal_aspect: bool = False, dashed: Sequence[str] = ()) -> str:
    """One SVG line plot: each (label, y) series against x (one array for
    all series, or a list with one per series), with a legend."""
    ys = [np.asarray(y, dtype=np.float64).reshape(-1) for _, y in series]
    xs = [np.asarray(xi, dtype=np.float64).reshape(-1) for xi in (x if isinstance(x, list) else [x] * len(ys))]
    x0, x1 = _range(xs)
    y0, y1 = _range(ys)
    pw, ph = w - _PAD_L - _PAD_R, h - _PAD_T - _PAD_B
    if equal_aspect:  # one metre is as long on both axes
        scale = min(pw / (x1 - x0), ph / (y1 - y0))
        cx, cy = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        x0, x1 = cx - 0.5 * pw / scale, cx + 0.5 * pw / scale
        y0, y1 = cy - 0.5 * ph / scale, cy + 0.5 * ph / scale
    out = _axes(title, w, h, x0, x1, y0, y1, xlabel, ylabel)
    for i, ((label, _), xv, yv) in enumerate(zip(series, xs, ys)):
        ok = np.isfinite(xv) & np.isfinite(yv)
        px = _PAD_L + (xv[ok] - x0) / (x1 - x0) * pw
        py = _PAD_T + ph - (yv[ok] - y0) / (y1 - y0) * ph
        pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
        color = _COLORS[i % len(_COLORS)]
        dash = ' stroke-dasharray="5,3"' if label in dashed else ""
        out.append(f'<polyline points="{pts}" fill="none" stroke="{color}" stroke-width="1.2"{dash}/>')
        ly = _PAD_T + 12 + 14 * i
        out.append(f'<line x1="{w - _PAD_R + 8}" y1="{ly - 3}" x2="{w - _PAD_R + 24}" y2="{ly - 3}" '
                   f'stroke="{color}" stroke-width="2"{dash}/>')
        out.append(f'<text x="{w - _PAD_R + 28}" y="{ly}">{html.escape(label)}</text>')
    out.append("</svg>")
    return "\n".join(out)


def raster_panel(title: str, rows: Sequence[Tuple[str, np.ndarray]], w: int = 800) -> str:
    """Boolean rows (label, (n_scans,)) as a scan-by-row raster."""
    n = max(len(r) for _, r in rows)
    rh = 10
    h = _PAD_T + rh * len(rows) + _PAD_B
    out = _axes(title, w, h, 0, max(n - 1, 0), 0, 0, xlabel="scan")[:-2]  # no y range labels
    pw = w - _PAD_L - _PAD_R
    cw = pw / max(n, 1)
    for j, (label, r) in enumerate(rows):
        y = _PAD_T + rh * j
        out.append(f'<text x="{_PAD_L - 4}" y="{y + rh - 2}" text-anchor="end" font-size="7">{html.escape(label)}</text>')
        for k in np.nonzero(np.asarray(r))[0]:
            out.append(f'<rect x="{_PAD_L + cw * k:.1f}" y="{y}" width="{max(cw, 1):.1f}" height="{rh}" '
                       f'fill="#1f77b4"/>')
    out.append("</svg>")
    return "\n".join(out)


def build_dashboard(path: str, tape, poses: np.ndarray, gt_poses: Optional[np.ndarray] = None,
                    metrics: Optional[dict] = None) -> None:
    poses = np.asarray(poses)
    t = _np(tape.timestamp)
    panels = []

    traj_x, traj_y = [poses[:, 0]], [("estimate", poses[:, 1])]
    if gt_poses is not None:
        traj_x.append(np.asarray(gt_poses)[:, 0])
        traj_y.append(("ground truth", np.asarray(gt_poses)[:, 1]))
    panels.append(("Trajectory", line_panel("Trajectory (XY)", traj_x, traj_y, w=620, h=560, xlabel="x [m]",
                                            ylabel="y [m]", equal_aspect=True, dashed=("ground truth",))))
    panels.append(("Per-axis pose", line_panel("Position per axis [m]", t, [(a, poses[:, i]) for i, a in
                                                                              enumerate("xyz")])
                   + "\n" + line_panel("Rotation vector per axis [rad]", t,
                                       [(a, poses[:, 3 + i]) for i, a in enumerate(["rx", "ry", "rz"])])))

    def panel(title, series):
        panels.append((title, line_panel(title, t, [(label, _np(y)) for label, y in series])))

    panel("Fusion controls", [("alpha", tape.fusion_alpha), ("beta", tape.power_beta)])
    panel("Pose-block conditioning", [
        ("cond_pose6 (log10)", np.log10(np.maximum(_np(tape.cond_pose6), 1.0))),
        ("eigmin_pose6 (log10)", np.log10(np.maximum(_np(tape.eigmin_pose6), 1e-30))),
    ])
    panel("Overconfidence sentinels", [
        ("dt_asymmetry", tape.overconfidence_dt_asymmetry),
        ("z_to_xy_ratio", tape.overconfidence_z_to_xy_ratio),
        ("ess_to_excitation", tape.overconfidence_ess_to_excitation),
    ])
    panel("Support / mismatch", [("ess_total", tape.support_ess_total), ("nll_per_ess", tape.mismatch_nll_per_ess),
                                 ("support_frac", tape.support_frac)])
    panel("Excitation coupling", [
        ("exc_dt_effect", tape.excitation_dt_effect),
        ("exc_ex_effect", tape.excitation_extrinsic_effect),
        ("1 - s_dt", tape.influence_dt_scale),
        ("1 - s_ex", tape.influence_extrinsic_scale),
    ])
    panel("ExpectedEffect: pose shift (predicted vs realized)", [
        ("predicted |d pose|", tape.ee_pose_shift_pred), ("realized |d pose|", tape.ee_pose_shift_real)])
    panel("ExpectedEffect: info gain (predicted vs realized)", [
        ("predicted alpha*tr(L_ev)", tape.ee_info_gain_pred), ("realized d tr(L)", tape.ee_info_gain_real)])
    panel("Map activity", [("valid_total", tape.map_valid_total), ("fused_mass", tape.map_fused_mass),
                           ("n_culled", tape.map_n_culled), ("n_merged", tape.map_n_merged)])
    panel("Map masses", [("insert_mass", tape.map_insert_mass), ("evicted_mass", tape.map_evicted_mass)])
    panel("OT transport", [("transport_mass", tape.ot_transport_mass),
                           ("marginal_defect_a", tape.ot_marginal_defect_a)])
    panel("Trigger magnitude / anchor drift / hypothesis spread", [
        ("total_trigger_magnitude", tape.total_trigger_magnitude),
        ("anchor_drift_rho", tape.influence_anchor_drift_rho),
        ("hyp_spread", tape.hyp_spread),
    ])
    panel("Stream health (scan IO)", [("n_points_valid", tape.io_n_points_valid),
                                      ("n_imu_valid", tape.io_n_imu_valid), ("n_cam_valid", tape.io_n_cam_valid)])
    panel("IMU coverage / loop factors", [("imu_coverage", tape.io_imu_coverage),
                                          ("loop_weight", tape.io_loop_weight)])

    # trigger timeline: which approximation fired on which scan
    masks = _np(tape.cert_triggers).astype(np.int64)
    active = [n for n in TRIGGER_NAMES if np.any(masks & TRIGGERS[n])]
    if active:
        panels.append(("Trigger timeline", raster_panel("Approximation trigger timeline",
                                                        [(n, (masks & TRIGGERS[n]) > 0) for n in active])))

    rows = []
    if metrics:
        rows.append(f"<pre>{html.escape(json.dumps(metrics, indent=2))}</pre>")
    for title, svg in panels:
        rows.append(f"<h3>{html.escape(title)}</h3>\n{svg}")
    page = ("<html><head><title>gcslam_torch run dashboard</title></head><body>"
            "<h1>gcslam_torch run dashboard</h1>" + "\n".join(rows) + "</body></html>")
    with open(path, "w") as f:
        f.write(page)
