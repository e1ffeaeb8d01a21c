"""Primitive-alignment pose evidence from OT soft correspondences
(counterpart of the JAX package's ops/evidence_pose.py).

The factor is the full 6x6 pose Laplace in the chart tangent (right
perturbation X = X0 Exp(dxi)) with the lever-arm coupling
A_i = [-I | [p_i]x], point-to-plane precision for surfels, Cauchy and
normal-consistency robust weights, plus the Matrix-Fisher rotation Laplace
H = V (tr(D) I - D) V^T at the scatter mode; translation and rotation
information are capped by whole-scan sigma floors with the MAP target held
fixed.

The association, the batch and the pose may carry a leading hypothesis dim
(one factor per hypothesis). Candidate attributes come from the shortlist's
CandidateSet, or from the view by pool row on the full-pool path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gcslam_torch import constants as C
from gcslam_torch.models.batch import MeasurementBatch, kappas, mean_directions, mean_positions
from gcslam_torch.ops import linalg, se3
from gcslam_torch.ops.binned import take_rows
from gcslam_torch.ops.certs import Cert, TRIGGERS, make_cert
from gcslam_torch.ops.se3 import mv
from gcslam_torch.utils.dtypes import BELIEF_DTYPE


def primitive_pose_evidence(
    assoc,  # AssociationResult
    batch: MeasurementBatch,
    z_lin_pose: torch.Tensor,  # (..., 6) world pose linearization point
    cfg,
    cands,  # association.CandidateSet, or None: gather from `view` by cand_pool
    pose_cauchy_r0_m: float,
    view=None,  # AtlasView (needed when cands is None)
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    f = BELIEF_DTYPE
    t0 = z_lin_pose[..., :3]
    R0 = se3.so3_exp(z_lin_pose[..., 3:6])
    R0T = R0.transpose(-1, -2)
    I3 = linalg.eye(3, R0)

    meas_pos = mean_positions(batch, cfg.eps_lift)  # (..., N, 3) body
    meas_dir = mean_directions(batch, cfg.eps_mass)
    meas_kap = kappas(batch)
    is_surfel = batch.sources == 1
    Lam_b = batch.Lambdas + cfg.eps_lift * I3
    if cfg.pose_point_to_plane:
        # surfels carry information along their normal only, capped at 1 cm
        n_hat = meas_dir
        lam_n = torch.sum(n_hat * mv(Lam_b, n_hat), dim=-1)
        lam_n = torch.clamp(lam_n, max=1.0 / (cfg.pose_sigma_floor_m**2))
        Lam_plane = lam_n[..., None, None] * n_hat[..., :, None] * n_hat[..., None, :]
        Lam_b = torch.where(is_surfel[..., None, None], Lam_plane + cfg.eps_lift * I3, Lam_b)
    tr = torch.diagonal(Lam_b, dim1=-2, dim2=-1).sum(-1)
    cap3 = 3.0 / (cfg.pose_sigma_floor_m**2)
    Lam_b = Lam_b * torch.clamp(cap3 / (tr + cfg.eps_mass), max=1.0)[..., None, None]

    if cands is not None:
        ci = assoc.cand_sl
        cand_view_valid = take_rows(cands.valid, ci)
        map_pos = take_rows(cands.pos, ci)
        map_dir = take_rows(cands.dirs, ci)
        map_kap = take_rows(cands.kap, ci)
        map_w = take_rows(cands.weights, ci)
        map_lfrac = None if cands.lidar_frac is None else take_rows(cands.lidar_frac, ci)
    else:
        cp = assoc.cand_pool
        cand_view_valid = view.valid[cp]
        map_pos = view.positions[cp]
        map_dir = view.directions[cp]
        map_kap = view.kappas[cp]
        map_w = view.weights[cp]
        map_lfrac = None if view.lidar_frac is None else view.lidar_frac[cp]

    pi = assoc.responsibilities * (batch.valid[..., None] & cand_view_valid).to(f)
    # pi/a_i x point support: point-count-consistent Laplace information
    n_valid = batch.valid.to(f).sum(-1)
    pi = pi * n_valid[..., None, None] * batch.weights[..., None]
    if cfg.pose_camera_weight != 1.0:
        pi = pi * torch.where(is_surfel, 1.0, cfg.pose_camera_weight)[..., None].to(f)

    r0_sq = pose_cauchy_r0_m**2
    meas_world = meas_pos @ R0T  # R0 p_i
    pair_r = map_pos - (meas_world + t0[..., None, :])[..., None, :]
    w_robust = 1.0 / (1.0 + torch.sum(pair_r * pair_r, dim=-1) / r0_sq)
    meas_dir_w = meas_dir @ R0T
    n_dot = torch.einsum("...ni,...nki->...nk", meas_dir_w, map_dir)
    if cfg.pose_rot_scatter_surfels_only:
        dir_fixed = is_surfel[..., None]
    else:
        dir_fixed = torch.ones_like(n_dot, dtype=torch.bool)
    w_normal = torch.where((meas_kap[..., None] > 0) & dir_fixed, n_dot * n_dot, 1.0)
    w_mature = map_w / (map_w + 1.0)
    pi = pi * (w_robust * w_normal) * w_mature
    if cfg.pose_modality_matched and map_lfrac is not None:
        lf = map_lfrac.to(f)
        if cfg.pose_modality_mode == "matched":
            w_mod = torch.where(is_surfel[..., None], lf, 1.0 - lf)
        else:
            w_mod = torch.where(is_surfel[..., None], 1.0, lf)
        pi = pi * w_mod

    # ---- full 6x6 pose Laplace in the chart tangent
    pi_sum_k = pi.sum(-1)
    r_world = map_pos - meas_world[..., None, :] - t0[..., None, None, :]
    r_tan = r_world @ R0.unsqueeze(-3)  # R0^T r per pair
    Px = se3.skew(meas_pos)
    LamPx = Lam_b @ Px
    PxLamPx = Px.transpose(-1, -2) @ LamPx
    L_tt = torch.einsum("...n,...nij->...ij", pi_sum_k, Lam_b)
    L_tr = -torch.einsum("...n,...nij->...ij", pi_sum_k, LamPx)
    L_rr = torch.einsum("...n,...nij->...ij", pi_sum_k, PxLamPx)
    L6 = torch.cat([torch.cat([L_tt, L_tr], -1), torch.cat([L_tr.transpose(-1, -2), L_rr], -1)], -2)

    r_weighted = torch.einsum("...nk,...nki->...ni", pi, r_tan)
    Lr = mv(Lam_b, r_weighted)
    h6 = torch.cat([Lr.sum(-2), -torch.einsum("...nji,...nj->...i", Px, Lr)], -1)
    trans_cost = torch.einsum("...nki,...nij,...nkj->...", r_tan * pi[..., None], Lam_b, r_tan)
    L6 = linalg.sym(L6) + cfg.eps_lift * linalg.eye(6, L6)

    # ---- rotation: Matrix-Fisher Laplace at the scatter mode
    kw = torch.sqrt(meas_kap[..., None] * map_kap + 1e-12) * pi
    kw = kw * dir_fixed.to(f)
    if cfg.pose_rot_scatter_surfels_only and map_lfrac is not None:
        kw = kw * map_lfrac.to(f)
    S = torch.einsum("...nk,...nki,...nj->...ij", kw, map_dir, meas_dir)
    R_star, D, V = linalg.rotation_from_scatter(S)
    H_diag = D.sum(-1, keepdim=True) - D
    L_rot, _ = linalg.domain_projection_psd(linalg.sym(V @ (H_diag[..., :, None] * V.transpose(-1, -2))),
                                            cfg.eps_psd)
    L_rot = L_rot + cfg.eps_lift * I3
    h_rot = mv(L_rot, se3.so3_log(R0T @ R_star))
    rot_cost = torch.sum(kw * (1.0 - torch.einsum("...ni,...nki->...nk", meas_dir_w, map_dir)), dim=(-2, -1))

    L6 = linalg.add_block(L6, L_rot, C.IDX_ROT, C.IDX_ROT)
    h6 = torch.cat([h6[..., :3], h6[..., 3:6] + h_rot], -1)

    # ---- correlated-error information floor (congruence scaling)
    delta_star, _ = linalg.spd_solve_lifted(
        linalg.sym(L6) + cfg.eps_lift * linalg.eye(6, L6), h6, cfg.eps_lift
    )
    eig_t, _ = linalg.eigh_3x3(linalg.sym(L6[..., 0:3, 0:3]))
    eig_r, _ = linalg.eigh_3x3(linalg.sym(L6[..., 3:6, 3:6]))
    cap_t = 1.0 / (cfg.pose_scan_sigma_floor_m**2)
    cap_r = 1.0 / (cfg.pose_scan_sigma_floor_rad**2)
    s_t = torch.clamp(cap_t / torch.clamp(eig_t[..., -1:], min=cfg.eps_lift), max=1.0)
    s_r = torch.clamp(cap_r / torch.clamp(eig_r[..., -1:], min=cfg.eps_lift), max=1.0)
    s_diag = torch.cat([torch.sqrt(s_t).expand(s_t.shape[:-1] + (3,)),
                        torch.sqrt(s_r).expand(s_r.shape[:-1] + (3,))], -1)
    L6 = linalg.sym(s_diag[..., :, None] * L6 * s_diag[..., None, :])
    h6 = mv(L6, delta_star)

    lead = L6.shape[:-2]
    L = linalg.add_block((cfg.eps_lift * linalg.eye(C.D_Z, L6)).expand(lead + (C.D_Z, C.D_Z)), L6,
                         C.IDX_POSE, C.IDX_POSE)
    h = linalg.set_slice(L6.new_zeros(lead + (C.D_Z,)), h6, C.IDX_POSE)

    ess = assoc.row_masses.sum(-1)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["linearization"] | TRIGGERS["ot_soft_correspondence"],
        frobenius_applied=1.0,
        ess_total=ess,
        support_frac=batch.valid.to(f).sum(-1) / batch.valid.shape[-1],
        nll_per_ess=(trans_cost + rot_cost) / (ess + cfg.eps_mass),
        lift_strength=cfg.eps_lift,
    )
    return L, h, cert
