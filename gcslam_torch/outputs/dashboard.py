"""Run dashboard (counterpart of the JAX package's outputs/dashboard.py):
trajectory, certificate sentinels and map stats as one HTML page, with the
same panels and titles. The panels are inline SVG drawn from numpy, so the
page needs no plotting package (the GPU hosts the port runs on have no
matplotlib)."""

from __future__ import annotations

import html
import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gcslam_torch.ops.certs import TRIGGER_NAMES, TRIGGERS
from gcslam_torch.outputs import svg_plot as sp


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def line_panel(title: str, x, series: Sequence[Tuple[str, np.ndarray]], w: int = 800, h: int = 240,
               xlabel: str = "", ylabel: str = "", equal_aspect: bool = False, dashed: Sequence[str] = ()) -> str:
    """One SVG line plot: each (label, y) series against x (one array for
    all series, or a list with one per series), with a legend."""
    xs = x if isinstance(x, list) else [x] * len(series)
    return sp.panel(title, [sp.Line(xi, y, label, label in dashed) for xi, (label, y) in zip(xs, series)],
                    w=w, h=h, xlabel=xlabel, ylabel=ylabel, equal_aspect=equal_aspect)


def raster_panel(title: str, rows: Sequence[Tuple[str, np.ndarray]], w: int = 800) -> str:
    """Boolean rows (label, (n_scans,)) as a scan-by-row raster."""
    n = max(len(r) for _, r in rows)
    rh = 10
    h = sp.PAD_T + rh * len(rows) + sp.PAD_B
    out = sp.frame(title, w, h, 0, max(n - 1, 0), 0, 0, xlabel="scan")[:-2]  # no y range labels
    pw = w - sp.PAD_L - sp.PAD_R
    cw = pw / max(n, 1)
    for j, (label, r) in enumerate(rows):
        y = sp.PAD_T + rh * j
        out.append(f'<text x="{sp.PAD_L - 4}" y="{y + rh - 2}" text-anchor="end" font-size="7">{html.escape(label)}</text>')
        for k in np.nonzero(np.asarray(r))[0]:
            out.append(f'<rect x="{sp.PAD_L + cw * k:.1f}" y="{y}" width="{max(cw, 1):.1f}" height="{rh}" '
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
