"""IMU evidence factors (counterpart of the JAX package's
ops/evidence_imu.py): time-resolved vMF gravity evidence with
transport-consistency reliability, the dependence inflation, and the gyro
rotation and preintegration velocity/position factors.

    transport error  e_k = |d f/dt + omega x f|
    reliability_k    = exp(-e_k^2 / 2 sigma^2), sigma = MAD-based
    Laplace at 0:    g = -kappa (mu0 x xbar),
                     H = kappa [ (x.mu) I - 1/2 (x mu^T + mu x^T) ]

The IMU window is shared; orientations, weights, biases and the
preintegrated increments may carry a leading hypothesis dim. In the default
'predict' IMU mode the gyro and preintegration factors are consumed by the
prediction, so they enter the evidence sum as the zero PreintFactor; the
'evidence' mode adds them as factors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.ops import linalg, se3
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS
from benchmark.reference.plain.ops.kappa import kappa_from_resultant
from benchmark.reference.plain.ops.se3 import mv


class GravityEvidence(NamedTuple):
    L: torch.Tensor  # (..., 22, 22)
    h: torch.Tensor  # (..., 22)
    kappa: torch.Tensor
    ess_weighted: torch.Tensor
    ess_raw: torch.Tensor
    mean_reliability: torch.Tensor
    transport_sigma: torch.Tensor
    Rbar: torch.Tensor


class PreintFactor(NamedTuple):
    L: torch.Tensor
    h: torch.Tensor
    r_vel: torch.Tensor
    r_pos: torch.Tensor


def zero_preint_factor(like: torch.Tensor) -> PreintFactor:
    """The preintegration factor of 'predict' mode: all zeros."""
    z3 = like.new_zeros(3)
    return PreintFactor(L=like.new_zeros(C.D_Z, C.D_Z), h=like.new_zeros(C.D_Z), r_vel=z3, r_pos=z3)


def median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim, averaging the two middle values for an even
    count (jnp.median semantics; torch.median returns the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    if n % 2:
        return s[..., n // 2]
    return 0.5 * (s[..., n // 2 - 1] + s[..., n // 2])


def _transport_consistency(accel: torch.Tensor, gyro: torch.Tensor, dt: torch.Tensor, eps: float):
    """|df/dt + omega x f| per sample (central differences; fwd/bwd at ends)."""
    mid = (accel[..., 2:, :] - accel[..., :-2, :]) / (2.0 * dt + eps)
    first = (accel[..., 1:2, :] - accel[..., 0:1, :]) / (dt + eps)
    last = (accel[..., -1:, :] - accel[..., -2:-1, :]) / (dt + eps)
    df = torch.cat([first, mid, last], dim=-2)
    e = df + torch.linalg.cross(gyro.expand_as(accel), accel)
    return torch.linalg.vector_norm(e, dim=-1)


def imu_gravity_evidence_time_resolved(
    rotvec_world_body: torch.Tensor,  # (..., 3)
    imu_accel: torch.Tensor,  # (M, 3)
    imu_gyro: torch.Tensor,  # (M, 3)
    weights: torch.Tensor,  # (..., M)
    accel_bias: torch.Tensor,  # (..., 3)
    gravity_W: torch.Tensor,  # (3,)
    dt_imu: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
    eps_mass: float = C.EPS_MASS,
) -> Tuple[GravityEvidence, Cert]:
    R0 = se3.so3_exp(rotvec_world_body)
    g_hat = gravity_W / (torch.linalg.vector_norm(gravity_W) + eps_mass)

    a_corr = imu_accel - accel_bias[..., None, :]  # (..., M, 3)
    e_mag = _transport_consistency(a_corr, imu_gyro, dt_imu, eps_mass)
    med = median_last(e_mag)
    mad = median_last((e_mag - med[..., None]).abs())
    sigma_t = mad / 0.6745 + eps_mass
    reliability = torch.exp(-0.5 * (e_mag / sigma_t[..., None]) ** 2)

    w = weights * reliability
    ess_w = w.sum(-1)
    ess_raw = weights.sum(-1)
    a_norm = torch.linalg.vector_norm(a_corr, dim=-1, keepdim=True)
    x_dir = a_corr / (a_norm + eps_mass)
    S = torch.sum(w[..., None] * x_dir, dim=-2)
    S_norm = torch.linalg.vector_norm(S, dim=-1)
    xbar = S / (S_norm[..., None] + eps_mass)
    Rbar = S_norm / (ess_w + eps_mass)

    kappa, _ = kappa_from_resultant(Rbar)

    mu0 = mv(R0.transpose(-1, -2), -g_hat)
    x_dot_mu = torch.sum(xbar * mu0, dim=-1)
    g_rot = -kappa[..., None] * torch.linalg.cross(mu0, xbar)
    outer = xbar[..., :, None] * mu0[..., None, :]
    H_rot = kappa[..., None, None] * (
        x_dot_mu[..., None, None] * linalg.eye(3, R0) - 0.5 * (outer + outer.transpose(-1, -2))
    )
    H_psd, pc = linalg.domain_projection_psd(linalg.sym(H_rot), eps_psd)
    L, h = linalg.embed_block(H_psd, -g_rot, C.IDX_ROT)

    mean_rel = reliability.mean(-1)
    nll = -kappa * x_dot_mu
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["ImuAccelDirectionTimeResolved"]
        | TRIGGERS["TransportConsistencyWeighting"]
        | TRIGGERS["KappaLowRApproximation"],
        eig_min=pc.eig_min,
        eig_max=pc.eig_max,
        cond=pc.cond,
        near_null_count=pc.near_null_count,
        ess_total=ess_w,
        support_frac=mean_rel,
        nll_per_ess=nll / (ess_w + eps_mass),
        directional_score=Rbar,
        psd_projection_delta=pc.projection_delta,
        mass_epsilon_ratio=ess_w / (ess_raw + eps_mass),
        trust_alpha=mean_rel,
    )
    result = GravityEvidence(
        L=L, h=h, kappa=kappa, ess_weighted=ess_w, ess_raw=ess_raw,
        mean_reliability=mean_rel, transport_sigma=sigma_t, Rbar=Rbar,
    )
    return result, cert


def imu_dependence_inflation(
    transport_sigma: torch.Tensor, eps_mass: float = C.EPS_MASS
) -> Tuple[torch.Tensor, Cert]:
    sigma = torch.clamp(transport_sigma, min=0.0)
    scale = 1.0 / (1.0 + sigma * sigma + eps_mass)
    cert = make_cert(exact=False, triggers=TRIGGERS["ImuDependenceInflation"], trust_alpha=scale)
    return scale, cert


def imu_gyro_rotation_evidence(
    rotvec_start_WB: torch.Tensor,  # (..., 3)
    rotvec_end_pred_WB: torch.Tensor,  # (..., 3)
    delta_rotvec_meas: torch.Tensor,  # (..., 3) preintegrated relative rotation
    Sigma_g: torch.Tensor,  # (3, 3) gyro PSD proxy
    dt_int: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Cert]:
    """Gyro rotation factor ('evidence' IMU mode): r = Log(R_end_pred^T
    R_start Exp(delta_rot_meas)), Sigma = Sigma_g dt_int, scaled by the
    continuous mass dt/(dt + eps). Returns (L, h, r_rot, cert)."""
    R_start = se3.so3_exp(rotvec_start_WB)
    R_end_imu = R_start @ se3.so3_exp(delta_rotvec_meas)
    R_end_pred = se3.so3_exp(rotvec_end_pred_WB)
    r_rot = se3.so3_log(R_end_pred.transpose(-1, -2) @ R_end_imu)

    dt_pos = torch.clamp(dt_int, min=0.0)
    dt_eff = dt_pos + C.EPS_MASS
    mass_scale = dt_pos / dt_eff  # -> 0 continuously when no samples

    Sigma_rot, _ = linalg.domain_projection_psd(Sigma_g * dt_eff, eps_psd)
    L_rot, lift = linalg.spd_inverse_lifted(Sigma_rot, eps_lift)
    L_scaled = mass_scale * L_rot
    L, h = linalg.embed_block(L_scaled, mv(L_scaled, r_rot), C.IDX_ROT)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["ImuGyroRotationGaussian"],
        nll_per_ess=0.5 * torch.sum(r_rot * mv(L_rot, r_rot), dim=-1),
        lift_strength=lift,
    )
    return L, h, r_rot, cert


def imu_preintegration_factor(
    p_start_world: torch.Tensor,  # (..., 3)
    rotvec_start_WB: torch.Tensor,  # (..., 3)
    v_start_world: torch.Tensor,  # (..., 3)
    p_end_pred_world: torch.Tensor,  # (..., 3)
    v_end_pred_world: torch.Tensor,  # (..., 3)
    rotvec_end_pred_WB: torch.Tensor,  # (..., 3)
    delta_v_body: torch.Tensor,  # (..., 3)
    delta_p_body: torch.Tensor,  # (..., 3)
    Sigma_a: torch.Tensor,  # (3, 3)
    dt_int: torch.Tensor,
    Sigma_prev_pos: torch.Tensor = None,  # (..., 3, 3) prior position marginal
    Sigma_prev_vel: torch.Tensor = None,  # (..., 3, 3) prior velocity marginal
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[PreintFactor, Cert]:
    """Preintegration velocity/position factor ('evidence' IMU mode):
    v_imu = v_i + R_i dv_body, p_imu = p_i + v_i dt + R_i dp_body with
    Sigma_v = Sigma_a dt, Sigma_p = Sigma_a dt^3, inflated by the head's own
    marginals (Sigma_v += Sigma_vv, Sigma_p += Sigma_pp + dt^2 Sigma_vv); the
    position residual is rotated into the predicted body frame."""
    R_start = se3.so3_exp(rotvec_start_WB)
    v_imu = v_start_world + mv(R_start, delta_v_body)
    p_imu = p_start_world + v_start_world * dt_int + mv(R_start, delta_p_body)
    r_vel = v_imu - v_end_pred_world
    R_pred = se3.so3_exp(rotvec_end_pred_WB)
    r_pos = mv(R_pred.transpose(-1, -2), p_imu - p_end_pred_world)

    dt_pos = torch.clamp(dt_int, min=0.0)
    dt_eff = dt_pos + C.EPS_MASS
    mass_scale = dt_pos / dt_eff

    Sv_extra = 0.0 if Sigma_prev_vel is None else Sigma_prev_vel
    Sp_extra = 0.0
    if Sigma_prev_pos is not None:
        Sp_extra = Sigma_prev_pos
    if Sigma_prev_vel is not None:
        Sp_extra = Sp_extra + dt_eff**2 * Sigma_prev_vel

    Sv, _ = linalg.domain_projection_psd(Sigma_a * dt_eff + Sv_extra, eps_psd)
    Sp, _ = linalg.domain_projection_psd(Sigma_a * dt_eff**3 + Sp_extra, eps_psd)
    Lv, lift_v = linalg.spd_inverse_lifted(Sv, eps_lift)
    Lp, lift_p = linalg.spd_inverse_lifted(Sp, eps_lift)
    Lv_s = mass_scale * Lv
    Lp_s = mass_scale * Lp

    batch = torch.broadcast_shapes(Lv_s.shape[:-2], Lp_s.shape[:-2], r_vel.shape[:-1], r_pos.shape[:-1])
    L = Lv_s.new_zeros(batch + (C.D_Z, C.D_Z))
    h = Lv_s.new_zeros(batch + (C.D_Z,))
    L[..., C.IDX_TRANS, C.IDX_TRANS] = Lp_s
    L[..., C.IDX_VEL, C.IDX_VEL] = Lv_s
    h[..., C.IDX_TRANS] = mv(Lp_s, r_pos)
    h[..., C.IDX_VEL] = mv(Lv_s, r_vel)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["ImuPreintegrationVelPos"],
        nll_per_ess=0.5 * (torch.sum(r_vel * mv(Lv, r_vel), dim=-1) + torch.sum(r_pos * mv(Lp, r_pos), dim=-1)),
        lift_strength=lift_v + lift_p,
    )
    return PreintFactor(L=L, h=h, r_vel=r_vel, r_pos=r_pos), cert
