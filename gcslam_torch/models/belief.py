"""Gaussian belief in information form on the 22D anchor chart (counterpart
of the JAX package's models/belief.py).

belief = (X_anchor, z_lin, L, h, stamp) with the lifted solve
delta_z* = (L + eps_lift I)^{-1} h and world pose X_anchor o Exp(delta_pose).
Fields may carry leading batch dims (one belief per hypothesis).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gcslam_torch import constants as C
from gcslam_torch.ops import linalg, se3
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, TIME_DTYPE


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
