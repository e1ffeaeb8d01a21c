"""vMF concentration from resultant length — single continuous blend
(counterpart of the JAX package's ops/kappa.py).

    k_low  = R (d - R^2) / (1 - R^2 + eps)
    k_high = -log(max(1 - R^2, eps))
    kappa  = (1 - s) k_low + s k_high,  s = sigmoid((R - R0)/tau)
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.plain import constants as C


def kappa_from_resultant(
    R_bar: torch.Tensor,
    d: float = 3.0,
    eps_r: float = C.EPS_R,
    r0: float = C.KAPPA_BLEND_R0,
    tau: float = C.KAPPA_BLEND_TAU,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (kappa, clamp_delta); works on any-shape tensors."""
    R_clamped = torch.clamp(R_bar, 0.0, 1.0 - eps_r)
    clamp_delta = (R_clamped - R_bar).abs()
    R2 = R_clamped * R_clamped
    k_low = R_clamped * (d - R2) / (1.0 - R2 + eps_r)
    k_high = -torch.log(torch.clamp(1.0 - R2, min=eps_r))
    s = torch.sigmoid((R_clamped - r0) / max(tau, 1e-6))
    return (1.0 - s) * k_low + s * k_high, clamp_delta
