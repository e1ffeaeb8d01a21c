"""BEV15 pushforward view layer (counterpart of the JAX package's ops/bev.py,
the reference's common/bev_pushforward.py:42-119; inactive in the runtime,
kept as a view module for splat rendering and diagnostics).

- 3-D Gaussian -> 2-D bird's-eye Gaussian under an oblique projection P
  (2 x 3): mu2 = P mu, Sigma2 = P Sigma P^T.
- 15 view projections swept in tilt between top-down and a maximally
  oblique view.
- vMF natural-parameter rotation into a view frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gcslam_torch.ops import se3

N_VIEWS = 15


def view_projections(n_views: int = N_VIEWS, max_tilt: float = np.pi / 3) -> np.ndarray:
    """(n_views, 2, 3) oblique BEV projections: tilt swept 0..max_tilt about
    the x axis, onto the plane spanned by x and (cos t) y + (sin t) z."""
    out = np.zeros((n_views, 2, 3))
    for i in range(n_views):
        tilt = max_tilt * i / max(n_views - 1, 1)
        out[i, 0] = [1.0, 0.0, 0.0]
        out[i, 1] = [0.0, np.cos(tilt), np.sin(tilt)]
    return out


def pushforward_gaussians(mu: torch.Tensor, Sigma: torch.Tensor, P: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mu (N, 3), Sigma (N, 3, 3), P (V, 2, 3) -> (mu2 (V, N, 2), Sigma2 (V, N, 2, 2))."""
    mu2 = torch.einsum("vij,nj->vni", P, mu)
    Sigma2 = torch.einsum("vij,njk,vlk->vnil", P, Sigma, P)
    return mu2, Sigma2


def rotate_vmf_etas(etas: torch.Tensor, rotvec: torch.Tensor) -> torch.Tensor:
    """Multi-lobe vMF natural parameters (N, B, 3) into a view frame:
    eta' = R eta (reference bev_pushforward.py:91)."""
    return torch.einsum("ij,nbj->nbi", se3.so3_exp(rotvec), etas)
