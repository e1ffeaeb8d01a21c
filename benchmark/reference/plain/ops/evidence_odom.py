"""Odometry + planar evidence factors on the 22D tangent (counterpart of
the JAX package's ops/evidence_odom.py).

Each factor returns (L (..., 22, 22), h (..., 22), Cert [, residuals]);
residuals are measurement minus prediction. Predicted poses/velocities may
carry a leading hypothesis dim; the odometry measurement is shared.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.ops import linalg, se3
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS
from benchmark.reference.plain.ops.se3 import mv


def _quad(r: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """r^T L r over the last dim."""
    return torch.sum(r * mv(L, r), dim=-1)


def odom_quadratic_evidence(
    pose_pred: torch.Tensor,  # (..., 6)
    odom_pose: torch.Tensor,  # (6,)
    odom_cov: torch.Tensor,  # (6, 6)
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    r_pose = se3.se3_log(se3.se3_relative(odom_pose, pose_pred))  # pred^{-1} o odom
    cov_psd, _ = linalg.domain_projection_psd(odom_cov, eps_psd)
    L_pose, lift = linalg.spd_inverse_lifted(cov_psd, eps_lift)
    L, h = linalg.embed_block(L_pose, mv(L_pose, r_pose), C.IDX_POSE)
    _, pc = linalg.domain_projection_psd(L_pose, eps_psd)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["OdomEvidenceGaussian"],
        eig_min=pc.eig_min,
        eig_max=pc.eig_max,
        cond=pc.cond,
        near_null_count=pc.near_null_count,
        nll_per_ess=0.5 * _quad(r_pose, L_pose),
        lift_strength=lift,
    )
    return L, h, cert


def odom_velocity_evidence(
    v_pred_world: torch.Tensor,  # (..., 3)
    R_world_body: torch.Tensor,  # (..., 3, 3)
    v_odom_body: torch.Tensor,  # (3,)
    Sigma_v: torch.Tensor,  # (3, 3)
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[torch.Tensor, torch.Tensor, Cert, torch.Tensor]:
    RT = R_world_body.transpose(-1, -2)
    r_vel_body = v_odom_body - mv(RT, v_pred_world)
    Sigma_psd, _ = linalg.domain_projection_psd(Sigma_v, eps_psd)
    L3_body, lift = linalg.spd_inverse_lifted(Sigma_psd, eps_lift)
    # the velocity tangent block is world-frame: transport residual + precision
    r_vel = mv(R_world_body, r_vel_body)
    L3 = R_world_body @ L3_body @ RT
    L, h = linalg.embed_block(L3, mv(L3, r_vel), C.IDX_VEL)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["OdomVelocityEvidence"],
        nll_per_ess=0.5 * _quad(r_vel, L3),
        lift_strength=lift,
    )
    return L, h, cert, r_vel


def odom_yawrate_evidence(
    omega_z_pred: torch.Tensor,
    omega_z_odom: torch.Tensor,
    sigma_wz: torch.Tensor,
    dt: torch.Tensor,
    var_prev_yaw: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    """Yaw-rate factor as a yaw-increment constraint r = (w_odom - w_pred) dt
    with variance sigma_wz^2 dt^2 + the prior yaw marginal."""
    r_wz = (omega_z_odom - omega_z_pred) * dt
    var = sigma_wz * sigma_wz * dt * dt + var_prev_yaw + C.EPS_MASS
    precision = 1.0 / var
    yaw = C.IDX_ROT.start + 2
    L, h = linalg.embed_block(precision[..., None, None], (precision * r_wz)[..., None],
                              slice(yaw, yaw + 1))
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["OdomYawRateEvidence"],
        nll_per_ess=0.5 * r_wz * r_wz * precision,
    )
    return L, h, cert


class KinematicConsistency(NamedTuple):
    L: torch.Tensor
    h: torch.Tensor
    r_trans: torch.Tensor
    r_rot: torch.Tensor


def pose_twist_kinematic_consistency(
    pose_prev: torch.Tensor,  # (..., 6)
    pose_curr: torch.Tensor,  # (..., 6)
    v_body: torch.Tensor,  # (3,)
    omega_body: torch.Tensor,  # (3,)
    dt: torch.Tensor,
    Sigma_v: torch.Tensor,  # (3, 3)
    Sigma_omega: torch.Tensor,  # (3, 3)
    Sigma_prev_pos: torch.Tensor,  # (..., 3, 3)
    Sigma_prev_rot: torch.Tensor,  # (..., 3, 3)
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[KinematicConsistency, Cert]:
    """Penalize pose change inconsistent with the integrated twist."""
    R_prev = se3.so3_exp(pose_prev[..., 3:6])
    R_curr = se3.so3_exp(pose_curr[..., 3:6])
    dp_pred = mv(R_prev, v_body) * dt
    dtheta_pred = omega_body * dt
    dp_actual = pose_curr[..., :3] - pose_prev[..., :3]
    dtheta_actual = se3.so3_log(R_prev.transpose(-1, -2) @ R_curr)
    r_trans = mv(R_curr.transpose(-1, -2), dp_pred - dp_actual)
    r_rot = dtheta_pred - dtheta_actual

    dt2 = dt * dt + eps_psd
    # St and Sr in one projection (on CUDA one launch)
    S, _ = linalg.domain_projection_psd(
        torch.stack(torch.broadcast_tensors(dt2 * Sigma_v + Sigma_prev_pos, dt2 * Sigma_omega + Sigma_prev_rot)),
        eps_psd)
    St, Sr = S.unbind(0)
    Lt, lift_t = linalg.spd_inverse_lifted(St, eps_lift)
    Lr, lift_r = linalg.spd_inverse_lifted(Sr, eps_lift)

    L_t, h_t = linalg.embed_block(Lt, mv(Lt, r_trans), C.IDX_TRANS)
    L_r, h_r = linalg.embed_block(Lr, mv(Lr, r_rot), C.IDX_ROT)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["PoseTwistKinematicConsistency"],
        nll_per_ess=0.5 * (_quad(r_trans, Lt) + _quad(r_rot, Lr)),
        lift_strength=lift_t + lift_r,
    )
    return KinematicConsistency(L=L_t + L_r, h=h_t + h_r, r_trans=r_trans, r_rot=r_rot), cert


def odom_dependence_inflation(
    r_trans: torch.Tensor, r_rot: torch.Tensor, eps_mass: float = C.EPS_MASS
) -> Tuple[torch.Tensor, Cert]:
    """scale = 1 / (1 + |r|^2) from pose<->twist inconsistency."""
    mag = torch.linalg.vector_norm(r_trans, dim=-1) + torch.linalg.vector_norm(r_rot, dim=-1)
    scale = 1.0 / (1.0 + mag * mag + eps_mass)
    cert = make_cert(exact=False, triggers=TRIGGERS["OdomDependenceInflation"], trust_alpha=scale)
    return scale, cert


def planar_z_prior(
    pose_pred: torch.Tensor, z_ref: float = C.PLANAR_Z_REF, sigma_z: float = C.PLANAR_Z_SIGMA
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    """Soft z = z_ref."""
    r_z = z_ref - pose_pred[..., 2]
    precision = 1.0 / (sigma_z * sigma_z)
    z = C.IDX_TRANS.start + 2
    L, h = linalg.embed_block(pose_pred.new_full((1, 1), precision), (precision * r_z)[..., None],
                              slice(z, z + 1))
    cert = make_cert(exact=False, triggers=TRIGGERS["PlanarZPrior"], device=pose_pred.device)
    return L, h, cert


def velocity_z_prior(
    v_z_pred: torch.Tensor, sigma_vz: float = C.PLANAR_VZ_SIGMA
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    """Soft v_z = 0 for ground robots."""
    precision = 1.0 / (sigma_vz * sigma_vz)
    vz = C.IDX_VEL.start + 2
    L, h = linalg.embed_block(v_z_pred.new_full((1, 1), precision), (precision * -v_z_pred)[..., None],
                              slice(vz, vz + 1))
    cert = make_cert(exact=False, triggers=TRIGGERS["VelocityZPrior"], device=v_z_pred.device)
    return L, h, cert
