"""Constant-twist deskew into the scan-END body frame (counterpart of
the JAX package's ops/deskew.py): p_end = Exp(xi)^{-1} Exp(alpha xi) (.) p per
point, alpha the point's phase in the scan window. The warp runs in
POINT_DTYPE; the soft time-membership reweighting does not depend on the
twist and is split out (`deskew_weights`) so per-hypothesis callers that
only need the certificate skip the point warp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gcslam_torch import constants as C
from gcslam_torch.ops import se3
from gcslam_torch.ops.certs import Cert, make_cert
from gcslam_torch.ops.se3 import mv
from gcslam_torch.ops.windows import smooth_window_weights
from gcslam_torch.utils.dtypes import POINT_DTYPE


def deskew_weights(
    timestamps: torch.Tensor,
    weights: torch.Tensor,
    scan_start_time: torch.Tensor,
    scan_end_time: torch.Tensor,
    ess_imu: torch.Tensor,
) -> Tuple[torch.Tensor, Cert]:
    """Soft time-window point weights and the deskew certificate."""
    denom = torch.clamp(scan_end_time - scan_start_time, min=1e-12)
    w_time = smooth_window_weights(timestamps, scan_start_time, scan_end_time,
                                   C.TIME_WARP_SIGMA_FRAC * denom)
    weights_out = (weights * w_time).to(POINT_DTYPE)
    retained = weights_out.sum() / (weights.sum() + C.EPS_MASS)
    cert = make_cert(exact=True, ess_total=ess_imu, support_frac=retained)
    return weights_out, cert


def deskew_points(
    points: torch.Tensor,  # (N, 3)
    timestamps: torch.Tensor,  # (N,)
    scan_start_time: torch.Tensor,
    scan_end_time: torch.Tensor,
    xi_body: torch.Tensor,  # (6,) twist over the scan interval
) -> torch.Tensor:
    """The point warp alone: (N, 3) points in the scan-end body frame."""
    denom = torch.clamp(scan_end_time - scan_start_time, min=1e-12)
    alpha = ((timestamps - scan_start_time) / denom).to(POINT_DTYPE)
    xi = xi_body.to(POINT_DTYPE)
    T_a = se3.se3_exp(alpha[:, None] * xi[None, :])  # (N, 6)
    p_start = mv(se3.so3_exp(T_a[:, 3:6]), points.to(POINT_DTYPE)) + T_a[:, :3]
    T_1 = se3.se3_exp(xi)
    R_1 = se3.so3_exp(T_1[3:6])
    return (p_start - T_1[None, :3]) @ R_1  # R_1^T (p - t) per row


def deskew_constant_twist(
    points: torch.Tensor,  # (N, 3)
    timestamps: torch.Tensor,  # (N,)
    weights: torch.Tensor,  # (N,)
    scan_start_time: torch.Tensor,
    scan_end_time: torch.Tensor,
    xi_body: torch.Tensor,  # (6,) twist over the scan interval
    ess_imu: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Cert]:
    p0 = deskew_points(points, timestamps, scan_start_time, scan_end_time, xi_body)
    weights_out, cert = deskew_weights(timestamps, weights, scan_start_time, scan_end_time, ess_imu)
    return p0, weights_out, cert
