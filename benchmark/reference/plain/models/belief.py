"""Gaussian belief in information form on the 22D anchor chart (counterpart
of the JAX package's models/belief.py).

belief = (X_anchor, z_lin, L, h, stamp) with the lifted solve
delta_z* = (L + eps_lift I)^{-1} h and world pose X_anchor o Exp(delta_pose).
Fields may carry leading batch dims (one belief per hypothesis).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.ops import linalg, se3
from benchmark.reference.plain.utils.dtypes import BELIEF_DTYPE, TIME_DTYPE


class Belief(NamedTuple):
    X_anchor: torch.Tensor  # (..., 6) SE(3) anchor as [trans, rotvec]
    z_lin: torch.Tensor  # (..., 22)
    L: torch.Tensor  # (..., 22, 22)
    h: torch.Tensor  # (..., 22)
    stamp: torch.Tensor  # (...,) TIME_DTYPE


def identity_prior(stamp: float = 0.0, device=None) -> Belief:
    """Weak prior at the identity anchor with physically scaled per-block
    variances; the pose block is pinned (the world frame is the start pose)."""
    var = torch.tensor(
        [1e-4] * 3 + [1e-4] * 3 + [1e2] * 3 + [1e-2] * 3 + [1e0] * 3 + [1e-4] + [1e-2] * 6,
        dtype=BELIEF_DTYPE, device=device,
    )
    return Belief(
        X_anchor=torch.zeros(6, dtype=BELIEF_DTYPE, device=device),
        z_lin=torch.zeros(C.D_Z, dtype=BELIEF_DTYPE, device=device),
        L=torch.diag(1.0 / var),
        h=torch.zeros(C.D_Z, dtype=BELIEF_DTYPE, device=device),
        stamp=torch.tensor(stamp, dtype=TIME_DTYPE, device=device),
    )


def from_moments(
    X_anchor: torch.Tensor,
    mean: torch.Tensor,
    cov: torch.Tensor,
    stamp: torch.Tensor,
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Belief:
    """Moment form -> info form with PSD projections (belief.py:255-326)."""
    cov_psd, _ = linalg.domain_projection_psd(cov, eps_psd)
    L, _ = linalg.spd_inverse_lifted(cov_psd, eps_lift)
    L_psd, _ = linalg.domain_projection_psd(L, eps_psd)
    mean = torch.as_tensor(mean, dtype=BELIEF_DTYPE, device=L_psd.device)
    return Belief(
        X_anchor=torch.as_tensor(X_anchor, dtype=BELIEF_DTYPE, device=L_psd.device),
        z_lin=mean,
        L=L_psd,
        h=se3.mv(L_psd, mean),
        stamp=torch.as_tensor(stamp, dtype=TIME_DTYPE, device=L_psd.device),
    )


def mean_increment(b: Belief, eps_lift: float = C.EPS_LIFT) -> torch.Tensor:
    x, _ = linalg.spd_solve_lifted(b.L, b.h, eps_lift)
    return x


def to_moments(b: Belief, eps_lift: float = C.EPS_LIFT) -> Tuple[torch.Tensor, torch.Tensor, float]:
    mean = mean_increment(b, eps_lift)
    cov, lift = linalg.spd_inverse_lifted(b.L, eps_lift)
    return mean, cov, lift


def world_pose(b: Belief, eps_lift: float = C.EPS_LIFT) -> torch.Tensor:
    """X_world = X_anchor o Exp(delta_xi_pose)."""
    delta = mean_increment(b, eps_lift)
    return se3.se3_compose(b.X_anchor, se3.se3_exp(delta[..., 0:6]))
