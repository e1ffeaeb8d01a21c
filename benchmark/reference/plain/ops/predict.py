"""Prediction operators (counterpart of the JAX package's ops/predict.py).

predict_diffusion ('evidence' IMU mode): the mean does not move and the
covariance follows the OU diffusion

    Sig' = e^{-2 lambda dt} Sig + (1 - e^{-2 lambda dt}) / (2 lambda) Q

predict_imu ('predict' IMU mode, the flagship filter): the preintegration
propagates the mean (pose composes the preintegrated delta, velocity
integrates the gravity-corrected accel) and its noise inflates the
covariance, EKF style:

    p'   = p + v dt + R dp_body
    R'   = R Exp(drotvec)
    v'   = v + R dv_body
    Sig' = J OU(Sig) J^T + blkdiag(Sg dt_int | Sa dt^3, Sa dt_int)

Both round-trip through moment form with PSD projections on the predicted
covariance and the re-inverted information matrix. Beliefs and increments
may carry a leading hypothesis dim; Q and the noise blocks are shared.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.models.belief import Belief
from benchmark.reference.plain.ops import linalg, se3
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS
from benchmark.reference.plain.ops.se3 import mv


def predict_diffusion(
    belief_prev: Belief,
    Q: torch.Tensor,
    dt_sec: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
    lambda_ou: float = C.OU_DAMPING_LAMBDA,
) -> Tuple[Belief, Cert]:
    mean_prev, _ = linalg.spd_solve_lifted(belief_prev.L, belief_prev.h, eps_lift)
    cov_prev, lift_prev = linalg.spd_inverse_lifted(belief_prev.L, eps_lift)

    exp_factor = torch.exp(-2.0 * lambda_ou * dt_sec)
    diffusion_coeff = (1.0 - exp_factor) / (2.0 * lambda_ou + torch.finfo(cov_prev.dtype).eps)
    cov_pred = exp_factor * cov_prev + diffusion_coeff * Q

    cov_psd, cert_cov = linalg.domain_projection_psd(cov_pred, eps_psd)
    L_pred, lift_inv = linalg.spd_inverse_lifted(cov_psd, eps_lift)
    L_psd, cert_L = linalg.domain_projection_psd(L_pred, eps_psd)
    h_pred = mv(L_psd, mean_prev)

    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["PredictDiffusion"],
        eig_min=cert_L.eig_min,
        eig_max=cert_L.eig_max,
        cond=cert_L.cond,
        near_null_count=cert_L.near_null_count,
        lift_strength=lift_prev + lift_inv,
        psd_projection_delta=cert_cov.projection_delta + cert_L.projection_delta,
        dt_scale=dt_sec,
    )
    belief_pred = Belief(
        X_anchor=belief_prev.X_anchor,
        z_lin=belief_prev.z_lin,
        L=L_psd,
        h=h_pred,
        stamp=belief_prev.stamp + dt_sec,
    )
    return belief_pred, cert


def predict_imu(
    belief_prev: Belief,
    Q: torch.Tensor,
    dt_sec: torch.Tensor,
    delta_pose_body: torch.Tensor,  # (..., 6)
    delta_v_body: torch.Tensor,  # (..., 3)
    dt_int: torch.Tensor,
    Sigma_g: torch.Tensor,  # (3, 3)
    Sigma_a: torch.Tensor,  # (3, 3)
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
    lambda_ou: float = C.OU_DAMPING_LAMBDA,
) -> Tuple[Belief, Cert]:
    mean_prev, _ = linalg.spd_solve_lifted(belief_prev.L, belief_prev.h, eps_lift)
    cov_prev, lift_prev = linalg.spd_inverse_lifted(belief_prev.L, eps_lift)

    # --- mean propagation (in the anchor chart)
    X_prev = se3.se3_compose(belief_prev.X_anchor, se3.se3_exp(mean_prev[..., C.IDX_POSE]))
    R_prev = se3.so3_exp(X_prev[..., 3:6])
    v_prev = mean_prev[..., C.IDX_VEL]

    p_new = X_prev[..., :3] + v_prev * dt_sec + mv(R_prev, delta_pose_body[..., :3])
    R_new = R_prev @ se3.so3_exp(delta_pose_body[..., 3:6])
    v_new = v_prev + mv(R_prev, delta_v_body)

    X_new = torch.cat([p_new, se3.so3_log(R_new)], dim=-1)
    pose_chart_new = se3.se3_log(se3.se3_relative(X_new, belief_prev.X_anchor))
    mean_new = torch.cat([pose_chart_new, v_new, mean_prev[..., 9:]], dim=-1)

    # --- covariance propagation
    exp_factor = torch.exp(-2.0 * lambda_ou * dt_sec)
    diffusion_coeff = (1.0 - exp_factor) / (2.0 * lambda_ou + torch.finfo(cov_prev.dtype).eps)
    cov_ou = exp_factor * cov_prev + diffusion_coeff * Q

    J = linalg.set_block(linalg.eye(C.D_Z, cov_ou), dt_sec * linalg.eye(3, cov_ou), C.IDX_TRANS, C.IDX_VEL)
    cov_pred = J @ cov_ou @ J.transpose(-1, -2)

    dt_i = torch.clamp(dt_int, min=0.0) + C.EPS_MASS
    add = torch.zeros_like(cov_pred[..., :9, :9])
    add[..., C.IDX_ROT, C.IDX_ROT] = Sigma_g * dt_i
    add[..., C.IDX_TRANS, C.IDX_TRANS] = Sigma_a * dt_i**3
    add[..., C.IDX_VEL, C.IDX_VEL] = Sigma_a * dt_i
    cov_pred = cov_pred.clone()
    cov_pred[..., :9, :9] += add

    cov_psd, cert_cov = linalg.domain_projection_psd(cov_pred, eps_psd)
    L_pred, lift_inv = linalg.spd_inverse_lifted(cov_psd, eps_lift)
    L_psd, cert_L = linalg.domain_projection_psd(L_pred, eps_psd)
    h_pred = mv(L_psd, mean_new)

    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["PredictDiffusion"] | TRIGGERS["ImuPreintegrationVelPos"],
        eig_min=cert_L.eig_min,
        eig_max=cert_L.eig_max,
        cond=cert_L.cond,
        near_null_count=cert_L.near_null_count,
        lift_strength=lift_prev + lift_inv,
        psd_projection_delta=cert_cov.projection_delta + cert_L.projection_delta,
        dt_scale=dt_sec,
    )
    belief_pred = Belief(
        X_anchor=belief_prev.X_anchor,
        z_lin=belief_prev.z_lin,
        L=L_psd,
        h=h_pred,
        stamp=belief_prev.stamp + dt_sec,
    )
    return belief_pred, cert
