"""Inverse-Wishart adaptive noise: process Q and per-sensor measurement Sigma
(counterpart of the JAX package's ops/iw.py).

Both are blockwise IW states updated every scan from commutative
sufficient statistics with forgetful retention. Suffstat functions accept a
leading hypothesis dim; the IW states themselves are shared.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gcslam_torch import constants as C
from gcslam_torch.ops import linalg, se3
from gcslam_torch.ops.se3 import mv
from gcslam_torch.utils.dtypes import BELIEF_DTYPE

# Process blocks over the 22D tangent: [trans, rot, vel, bg, ba, dt(1), ex(6)]
PROCESS_BLOCK_DIMS = np.array([3, 3, 3, 3, 3, 1, 6], dtype=np.int64)
PROCESS_BLOCK_STARTS = np.array([0, 3, 6, 9, 12, 15, 16], dtype=np.int64)
_rows = np.arange(6)[None, :] < PROCESS_BLOCK_DIMS[:, None]
PROCESS_BLOCK_MASKS = (_rows[:, :, None] & _rows[:, None, :]).astype(np.float64)  # (7,6,6)

PROCESS_RHO = np.array(
    [C.IW_RHO_TRANS, C.IW_RHO_ROT, C.IW_RHO_VEL, C.IW_RHO_BG, C.IW_RHO_BA, C.IW_RHO_DT, C.IW_RHO_EX]
)
MEAS_RHO = np.array([C.IW_RHO_MEAS_GYRO, C.IW_RHO_MEAS_ACCEL, C.IW_RHO_MEAS_LIDAR])

# Flat gather index: (7, 6) block coordinate -> tangent coordinate; padding
# rows point at a zero column appended at index D_Z.
_pad = np.full((7, 6), C.D_Z, dtype=np.int64)
for _b in range(7):
    _d = int(PROCESS_BLOCK_DIMS[_b])
    _pad[_b, :_d] = PROCESS_BLOCK_STARTS[_b] + np.arange(_d)
_BLOCK_INDEX = _pad


class ProcessNoiseIW(NamedTuple):
    nu: torch.Tensor  # (7,)
    Psi: torch.Tensor  # (7, 6, 6) zero-padded blocks


class MeasurementNoiseIW(NamedTuple):
    """Blocks: [gyro (PSD rad^2/s), accel (PSD m^2/s^3), lidar (cov m^2)]."""

    nu: torch.Tensor  # (3,)
    Psi: torch.Tensor  # (3, 3, 3)


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=BELIEF_DTYPE, device=device)


def datasheet_process_noise(device=None) -> ProcessNoiseIW:
    dims = PROCESS_BLOCK_DIMS.astype(np.float64)
    diffusion = np.array([
        C.PROCESS_TRANS_DIFFUSION, C.PROCESS_ROT_DIFFUSION, C.PROCESS_VEL_DIFFUSION,
        C.PROCESS_BG_DIFFUSION, C.PROCESS_BA_DIFFUSION, C.PROCESS_DT_DIFFUSION,
        C.PROCESS_EXTRINSIC_DIFFUSION,
    ])
    Psi = np.zeros((7, 6, 6))
    for i in range(7):
        d = int(PROCESS_BLOCK_DIMS[i])
        Psi[i, :d, :d] = np.eye(d) * diffusion[i] * C.IW_NU_WEAK_ADD
    return ProcessNoiseIW(nu=_t(dims + 1.0 + C.IW_NU_WEAK_ADD, device), Psi=_t(Psi, device))


def datasheet_measurement_noise(lidar_sigma: float = C.LIDAR_SIGMA_MEAS, device=None) -> MeasurementNoiseIW:
    Psi = np.stack([
        np.eye(3) * C.IMU_GYRO_NOISE_DENSITY * C.IW_NU_WEAK_ADD,
        np.eye(3) * C.IMU_ACCEL_NOISE_DENSITY * C.IW_NU_WEAK_ADD,
        np.eye(3) * lidar_sigma * C.IW_NU_WEAK_ADD,
    ])
    return MeasurementNoiseIW(nu=_t(np.full(3, 3.0 + 1.0 + C.IW_NU_WEAK_ADD), device), Psi=_t(Psi, device))


def process_noise_to_Q(state: ProcessNoiseIW, eps_psd: float = C.EPS_PSD) -> torch.Tensor:
    """22x22 Q from blockwise IW means E[Sigma] = Psi/(nu - p - 1)."""
    dev = state.Psi.device
    dims = _t(PROCESS_BLOCK_DIMS, dev)
    denom = linalg.softplus_positive(state.nu - dims - 1.0)
    Q_blocks = state.Psi / denom[:, None, None] * _t(PROCESS_BLOCK_MASKS, dev)
    Q = state.Psi.new_zeros(C.D_Z, C.D_Z)
    for i in range(7):
        s = int(PROCESS_BLOCK_STARTS[i])
        d = int(PROCESS_BLOCK_DIMS[i])
        Q[s:s + d, s:s + d] = Q_blocks[i, :d, :d]
    Q_psd, _ = linalg.domain_projection_psd(Q, eps_psd)
    return Q_psd


def _pack_blocks_vec(r: torch.Tensor) -> torch.Tensor:
    """(..., 22) -> (..., 7, 6) zero-padded per-block vectors."""
    r_pad = torch.cat([r, r.new_zeros(r.shape[:-1] + (1,))], dim=-1)
    idx = torch.as_tensor(_BLOCK_INDEX, device=r.device)
    return r_pad[..., idx]


def _pack_blocks_mat(S: torch.Tensor) -> torch.Tensor:
    """(..., 22, 22) -> (..., 7, 6, 6) zero-padded diagonal blocks."""
    z_row = S.new_zeros(S.shape[:-2] + (1, S.shape[-1]))
    S_pad = torch.cat([S, z_row], dim=-2)
    S_pad = torch.cat([S_pad, S_pad.new_zeros(S_pad.shape[:-1] + (1,))], dim=-1)
    idx = torch.as_tensor(_BLOCK_INDEX, device=S.device)
    return S_pad[..., idx[:, :, None], idx[:, None, :]]


def process_iw_suffstats(
    L_pred: torch.Tensor,
    h_pred: torch.Tensor,
    L_post: torch.Tensor,
    h_post: torch.Tensor,
    eps_lift: float,
    L_evidence: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dPsi_b = w_b (r r^T + Sigma_post)_b, dnu_b = w_b with r = mu_post -
    mu_pred and the observability weight w_b = tr(L_ev,b)/(tr(L_ev,b)+tr(L_pred,b))."""
    mu_pred, _ = linalg.spd_solve_lifted(L_pred, h_pred, eps_lift)
    mu_post, _ = linalg.spd_solve_lifted(L_post, h_post, eps_lift)
    Sigma_post, _ = linalg.spd_inverse_lifted(L_post, eps_lift)
    r_blocks = _pack_blocks_vec(mu_post - mu_pred)
    rrT = r_blocks[..., :, None] * r_blocks[..., None, :]
    masks = _t(PROCESS_BLOCK_MASKS, L_pred.device)
    dPsi = (rrT + _pack_blocks_mat(Sigma_post)) * masks
    tr_ev = linalg.trace(_pack_blocks_mat(L_evidence))
    tr_pr = linalg.trace(_pack_blocks_mat(L_pred))
    w = tr_ev / (tr_ev + tr_pr + C.EPS_MASS)
    return dPsi * w[..., None, None], w


def process_iw_apply(
    state: ProcessNoiseIW,
    dPsi: torch.Tensor,
    dnu: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
    nu_max: float = C.IW_NU_MAX,
) -> ProcessNoiseIW:
    """Forgetful update Psi <- rho Psi + dPsi, nu <- rho nu + dnu with
    per-block PSD projection and smooth nu clipping."""
    dev = state.Psi.device
    rho = _t(PROCESS_RHO, dev)
    masks = _t(PROCESS_BLOCK_MASKS, dev)
    Psi_raw = (rho[:, None, None] * state.Psi + dPsi) * masks
    Psi_psd, _ = linalg.domain_projection_psd(Psi_raw, eps_psd)
    nu_raw = rho * state.nu + dnu
    nu_min = _t(PROCESS_BLOCK_DIMS, dev) + 1.0 + C.IW_NU_WEAK_ADD
    nu = linalg.smooth_interval_project(nu_raw, nu_min, nu_max)
    return ProcessNoiseIW(nu=nu, Psi=Psi_psd * masks)


def measurement_noise_mode(state: MeasurementNoiseIW, idx: int, eps_psd: float = C.EPS_PSD) -> torch.Tensor:
    """IW mode Sigma = Psi/(nu + p + 1)."""
    Sigma, _ = linalg.domain_projection_psd(state.Psi[idx] / (state.nu[idx] + 3.0 + 1.0), eps_psd)
    return Sigma


def measurement_iw_apply(
    state: MeasurementNoiseIW,
    dPsi: torch.Tensor,
    dnu: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
    nu_max: float = C.IW_NU_MAX,
) -> MeasurementNoiseIW:
    rho = _t(MEAS_RHO, state.Psi.device)
    Psi_psd, _ = linalg.domain_projection_psd(linalg.sym(rho[:, None, None] * state.Psi + dPsi), eps_psd)
    nu_raw = rho * state.nu + dnu
    nu_min = torch.full_like(state.nu, 3.0 + 1.0 + C.IW_NU_WEAK_ADD)
    return MeasurementNoiseIW(nu=linalg.smooth_interval_project(nu_raw, nu_min, nu_max), Psi=Psi_psd)


def _weighted_outer(w_norm: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sum_m w_m r_m r_m^T over dim -2 of r."""
    return (w_norm[..., :, None] * r).transpose(-1, -2) @ r


def _one_block(block: torch.Tensor, which: int, weight=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3, 3, 3) suffstat with `block` in slot `which`; dnu = weight there."""
    batch = block.shape[:-2]
    dPsi = block.new_zeros(batch + (3, 3, 3))
    dPsi[..., which, :, :] = block
    dnu = block.new_zeros(batch + (3,))
    dnu[..., which] = weight
    return dPsi, dnu


def gyro_meas_suffstats(imu_gyro, weights, gyro_bias, omega_avg, dt_imu, eps_mass=C.EPS_MASS):
    """Weighted outer products of rate residuals (gyro - bg - omega_avg) x dt_imu."""
    w_norm = weights / (weights.sum(-1, keepdim=True) + eps_mass)
    r = imu_gyro - gyro_bias[..., None, :] - omega_avg[..., None, :]
    rrT_psd, _ = linalg.domain_projection_psd(linalg.sym(_weighted_outer(w_norm, r)))
    return _one_block(rrT_psd * torch.clamp(dt_imu, min=1e-12), 0)


def accel_meas_suffstats(rotvec_world_body, imu_accel, weights, accel_bias, gravity_W, dt_imu,
                         eps_mass=C.EPS_MASS):
    """Residuals vs the predicted specific force -R^T g."""
    R0 = se3.so3_exp(rotvec_world_body)
    f_pred = -mv(R0.transpose(-1, -2), gravity_W)
    w_norm = weights / (weights.sum(-1, keepdim=True) + eps_mass)
    r = imu_accel - accel_bias[..., None, :] - f_pred[..., None, :]
    rrT_psd, _ = linalg.domain_projection_psd(linalg.sym(_weighted_outer(w_norm, r)))
    return _one_block(rrT_psd * torch.clamp(dt_imu, min=1e-12), 1)


def lidar_meas_suffstats(residuals: torch.Tensor, weights: torch.Tensor, eps_mass: float = C.EPS_MASS):
    """LiDAR translation suffstats from weighted residual outer products
    (residuals (..., R, 3), weights (..., R)), scaled by the continuous
    support s = w_sum / (w_sum + 0.1)."""
    w_sum = weights.sum(-1)
    w_norm = weights / (w_sum[..., None] + eps_mass)
    rrT_psd, _ = linalg.domain_projection_psd(linalg.sym(_weighted_outer(w_norm, residuals)))
    support = w_sum / (w_sum + 0.1)
    return _one_block(support[..., None, None] * rrT_psd, 2, support)
