"""IMU preintegration with a log-depth cumulative rotation product
(counterpart of the JAX package's ops/preintegration.py).

    dt_eff_k = w_k (t_{k+1} - t_k)
    R_{k+1}  = R_k Exp((gyro_k - bg) dt_eff_k),  R_0 = R_start
    a_w_k    = R_k (accel_k - ba) + g
    v_{k+1}  = v_k + a_w_k dt_eff_k
    p_{k+1}  = p_k + v_k dt_eff_k + 1/2 a_w_k dt_eff_k^2

The only sequential dependency is the cumulative product of the per-sample
rotations; it is computed by a Hillis-Steele scan (log2(M) batched 3x3
matmuls) in place of jax.lax.associative_scan. The IMU window is shared;
the membership weights, start orientation, biases and target time may
carry leading batch dims (windows x hypotheses).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.ops import se3
from benchmark.reference.plain.ops.se3 import mv
from benchmark.reference.plain.utils.dtypes import BELIEF_DTYPE


class PreintResult(NamedTuple):
    delta_pose: torch.Tensor  # (..., 6) [p_body, rotvec_delta] start-body frame
    delta_R: torch.Tensor  # (..., 3, 3)
    delta_p: torch.Tensor  # (..., 3)
    delta_v: torch.Tensor  # (..., 3)
    ess: torch.Tensor  # (...,)
    dt_eff_sum: torch.Tensor  # (...,)


def cumulative_matmul(mats: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product P_k = A_0 @ ... @ A_k along dim -3 in
    ceil(log2 M) batched steps."""
    P = mats
    M = P.shape[-3]
    shift = 1
    while shift < M:
        P = torch.cat([P[..., :shift, :, :], P[..., :-shift, :, :] @ P[..., shift:, :, :]], dim=-3)
        shift *= 2
    return P


def preintegrate(
    imu_stamps: torch.Tensor,  # (M,) zero-padded
    imu_gyro: torch.Tensor,  # (M, 3)
    imu_accel: torch.Tensor,  # (M, 3)
    weights: torch.Tensor,  # (..., M)
    rotvec_start_WB: torch.Tensor,  # (..., 3)
    gyro_bias: torch.Tensor,  # (..., 3)
    accel_bias: torch.Tensor,  # (..., 3)
    gravity_W: torch.Tensor,  # (3,)
    target_dt: torch.Tensor,  # (...,)
) -> PreintResult:
    dtype = imu_gyro.dtype
    dt = torch.cat([(imu_stamps[1:] - imu_stamps[:-1]).to(dtype), imu_gyro.new_zeros(1)])
    dt = torch.clamp(dt, min=0.0)
    dt_eff = weights.to(dtype) * dt  # (..., M)
    # Renormalize total effective time to the known coverage (soft-window
    # edge deficit); the clip keeps dropout windows from fabricating motion.
    scale = target_dt.to(dtype) / torch.clamp(dt_eff.sum(-1), min=1e-9)
    dt_eff = dt_eff * torch.clamp(scale, 0.0, 1.5)[..., None]

    omega = (imu_gyro - gyro_bias[..., None, :]) * dt_eff[..., None]  # (..., M, 3)
    P = cumulative_matmul(se3.so3_exp(omega))  # (..., M, 3, 3)
    eye = torch.eye(3, dtype=dtype, device=P.device).expand(P.shape[:-3] + (1, 3, 3))
    Cx = torch.cat([eye, P[..., :-1, :, :]], dim=-3)  # exclusive product

    R_start = se3.so3_exp(rotvec_start_WB.to(dtype))  # (..., 3, 3)
    a_body = imu_accel - accel_bias[..., None, :]  # (..., M, 3)
    a_world_nog = mv(R_start[..., None, :, :] @ Cx, a_body)
    a_world = a_world_nog + gravity_W.to(dtype)

    impulse = a_world * dt_eff[..., None]
    v_incl = torch.cumsum(impulse, dim=-2)
    v_excl = v_incl - impulse
    v_end = v_incl[..., -1, :]
    p_end = torch.sum(v_excl * dt_eff[..., None] + 0.5 * a_world * (dt_eff * dt_eff)[..., None], dim=-2)

    delta_R = P[..., -1, :, :]
    R_startT = R_start.transpose(-1, -2)
    p_body = mv(R_startT, p_end)
    v_body = mv(R_startT, v_end)
    return PreintResult(
        delta_pose=torch.cat([p_body, se3.so3_log(delta_R)], dim=-1),
        delta_R=delta_R,
        delta_p=p_body,
        delta_v=v_body,
        ess=weights.sum(-1),
        dt_eff_sum=dt_eff.sum(-1),
    )


def imu_integration_time(imu_stamps: torch.Tensor, t_start, t_end) -> torch.Tensor:
    """Sum of IMU sample intervals inside (t_start, t_end] (telescoped to
    max - min of the valid stamps); zero with fewer than 2 valid samples."""
    eps = 1e-9
    valid = (imu_stamps > t_start - eps) & (imu_stamps <= t_end + eps) & (imu_stamps > 0.0)
    n_valid = valid.sum()
    t_max = torch.where(valid, imu_stamps, -1e30).amax()
    t_min = torch.where(valid, imu_stamps, 1e30).amin()
    dt_int = torch.clamp(t_max - t_min, min=0.0)
    dt_int = torch.minimum(dt_int, torch.clamp(t_end - t_start, min=0.0))
    return torch.where(n_valid >= 2, dt_int, 0.0).to(BELIEF_DTYPE)


def imu_mean_sample_period(imu_stamps: torch.Tensor) -> torch.Tensor:
    """Average IMU sampling period over the valid (nonzero) stamps."""
    valid = imu_stamps > 0.0
    n = valid.sum()
    t_max = torch.where(valid, imu_stamps, -1e30).amax()
    t_min = torch.where(valid, imu_stamps, 1e30).amin()
    dt = torch.where(n >= 2, (t_max - t_min) / torch.clamp(n - 1, min=1), 0.0)
    return torch.clamp(dt, min=1e-12).to(BELIEF_DTYPE)
