"""Evidence tempering, excitation scaling, fusion alpha, additive info fusion
(counterpart of the JAX package's ops/fusion.py). Batched over leading dims."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS


class ObservabilitySentinels(NamedTuple):
    dt_asymmetry: torch.Tensor
    z_to_xy_ratio: torch.Tensor


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def observability_sentinels(L_ev: torch.Tensor, eps: float = C.EPS_MASS) -> ObservabilitySentinels:
    dt = C.IDX_DT
    dt_pose = _norm(L_ev[..., dt, C.IDX_POSE]) + _norm(L_ev[..., C.IDX_POSE, dt])
    dt_vel = _norm(L_ev[..., dt, C.IDX_VEL]) + _norm(L_ev[..., C.IDX_VEL, dt])
    dt_asym = torch.clamp((dt_vel - dt_pose).abs() / (dt_vel + dt_pose + eps), 0.0, 1.0)
    L_xx = L_ev[..., 0, 0].abs()
    L_yy = L_ev[..., 1, 1].abs()
    L_zz = L_ev[..., 2, 2].abs()
    return ObservabilitySentinels(dt_asymmetry=dt_asym, z_to_xy_ratio=L_zz / (0.5 * (L_xx + L_yy) + eps))


def power_tempering_beta(
    sentinels: ObservabilitySentinels,
    ess_total: torch.Tensor,
    excitation_total: torch.Tensor,
    beta_min: float = C.POWER_BETA_MIN,
    exc_c: float = C.POWER_BETA_EXC_C,
    z_c: float = C.POWER_BETA_Z_C,
    eps_mass: float = C.EPS_MASS,
) -> Tuple[torch.Tensor, Cert]:
    ess_to_exc = ess_total / (excitation_total + eps_mass)
    s_z = sentinels.z_to_xy_ratio / (sentinels.z_to_xy_ratio + z_c)
    s_exc = 1.0 / (1.0 + ess_to_exc / exc_c)
    s = torch.clamp(sentinels.dt_asymmetry * s_z * s_exc, 0.0, 1.0)
    beta = torch.clamp(beta_min + (1.0 - beta_min) * s, beta_min, 1.0)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["PowerTempering"],
        frobenius_applied=((1.0 - beta).abs() > 0.0).to(beta.dtype),
        power_beta=beta,
    )
    return beta, cert


def excitation_scales(
    L_evidence: torch.Tensor, L_prior: torch.Tensor, eps: float = C.EXC_EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    e_dt = L_evidence[..., C.IDX_DT, C.IDX_DT]
    e_ex = linalg.trace(L_evidence[..., C.IDX_EX, C.IDX_EX])
    pi_dt = L_prior[..., C.IDX_DT, C.IDX_DT]
    pi_ex = linalg.trace(L_prior[..., C.IDX_EX, C.IDX_EX])
    return e_dt / (e_dt + pi_dt + eps), e_ex / (e_ex + pi_ex + eps)


def apply_excitation_prior_scaling(
    L_prior: torch.Tensor, h_prior: torch.Tensor, s_dt: torch.Tensor, s_ex: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    """Scale dt/extrinsic prior rows+cols by (1 - s)."""
    a_dt = 1.0 - s_dt
    a_ex = 1.0 - s_ex
    batch = a_dt.shape
    scale = torch.cat(
        [
            L_prior.new_ones(batch + (C.IDX_DT,)),
            a_dt[..., None],
            a_ex[..., None].expand(batch + (6,)),
        ],
        dim=-1,
    )
    Lp = L_prior * (scale[..., :, None] * scale[..., None, :])
    hp = h_prior * scale
    cert = make_cert(
        exact=False, triggers=TRIGGERS["ExcitationPriorScaling"], dt_scale=a_dt, ex_scale=a_ex,
    )
    return Lp, hp, cert


def fusion_alpha(
    cond_evidence: torch.Tensor,
    ess_evidence: torch.Tensor,
    support_frac: torch.Tensor,
    excitation_total: torch.Tensor,
    dt_asymmetry: torch.Tensor,
    z_to_xy_ratio: torch.Tensor,
    power_beta: torch.Tensor,
    nll_per_ess: torch.Tensor,
    alpha_min: float = C.ALPHA_MIN,
    alpha_max: float = C.ALPHA_MAX,
    c0_cond: float = C.C0_COND,
    eps_mass: float = C.EPS_MASS,
) -> Tuple[torch.Tensor, Cert]:
    """Continuous trust alpha in [alpha_min, alpha_max]."""
    cond_quality = c0_cond / (cond_evidence + c0_cond)
    support_quality = ess_evidence / (ess_evidence + 1.0)
    mismatch_quality = torch.exp(-nll_per_ess)
    dt_quality = torch.clamp(dt_asymmetry, 0.0, 1.0)
    z_quality = torch.clamp(z_to_xy_ratio / (z_to_xy_ratio + 1.0), 0.0, 1.0)
    exc_quality = torch.clamp(excitation_total / (excitation_total + 1.0), 0.0, 1.0)
    base = torch.sqrt(cond_quality * support_quality)
    quality = (
        base * mismatch_quality * dt_quality * z_quality * exc_quality
        * torch.clamp(power_beta, 0.0, 1.0)
    )
    alpha = torch.clamp(alpha_min + (alpha_max - alpha_min) * quality, alpha_min, alpha_max)
    cert = make_cert(
        exact=True,
        trust_alpha=alpha,
        exc_dt_effect=excitation_total,
        ess_total=ess_evidence,
        support_frac=support_frac,
    )
    return alpha, cert


def info_fusion_additive(
    L_pred: torch.Tensor,
    h_pred: torch.Tensor,
    L_evidence: torch.Tensor,
    h_evidence: torch.Tensor,
    alpha: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    L_post_raw = L_pred + alpha[..., None, None] * L_evidence
    h_post = h_pred + alpha[..., None] * h_evidence
    L_post, pc = linalg.domain_projection_psd(L_post_raw, eps_psd)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["InfoFusionAdditive"],
        eig_min=pc.eig_min,
        eig_max=pc.eig_max,
        cond=pc.cond,
        near_null_count=pc.near_null_count,
        psd_projection_delta=pc.projection_delta,
        trust_alpha=alpha,
    )
    return L_post, h_post, cert
