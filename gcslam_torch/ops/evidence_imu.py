"""IMU evidence factors on the slice's path (counterpart of
the JAX package's ops/evidence_imu.py): time-resolved vMF gravity evidence with
transport-consistency reliability, and the dependence inflation.

    transport error  e_k = |d f/dt + omega x f|
    reliability_k    = exp(-e_k^2 / 2 sigma^2), sigma = MAD-based
    Laplace at 0:    g = -kappa (mu0 x xbar),
                     H = kappa [ (x.mu) I - 1/2 (x mu^T + mu x^T) ]

The IMU window is shared; orientation, weights and accel bias may carry a
leading hypothesis dim. In the default 'predict' IMU mode the gyro and
preintegration factors are consumed by the prediction, so they enter the
evidence sum as the zero PreintFactor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gcslam_torch import constants as C
from gcslam_torch.ops import linalg, se3
from gcslam_torch.ops.certs import Cert, make_cert, TRIGGERS
from gcslam_torch.ops.kappa import kappa_from_resultant
from gcslam_torch.ops.se3 import mv


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
