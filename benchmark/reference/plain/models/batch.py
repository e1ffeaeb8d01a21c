"""MeasurementBatch: fixed-size SoA of measurement primitives (counterpart of
the JAX package's models/batch.py). Camera rows first, LiDAR surfel rows after;
Gaussians in (Lambda, theta) form, vMF as multi-lobe etas; `valid` masks
padding. With the camera off the camera slice has zero rows."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.utils.dtypes import BELIEF_DTYPE


class MeasurementBatch(NamedTuple):
    Lambdas: torch.Tensor  # (N, 3, 3)
    thetas: torch.Tensor  # (N, 3)
    etas: torch.Tensor  # (N, B, 3)
    weights: torch.Tensor  # (N,)
    sources: torch.Tensor  # (N,) int32: 0=camera, 1=lidar
    valid: torch.Tensor  # (N,) bool
    timestamps: torch.Tensor  # (N,)
    colors: torch.Tensor  # (N, 3)


def mean_positions(b: MeasurementBatch, eps_lift: float = C.EPS_LIFT) -> torch.Tensor:
    return linalg.solve3x3(b.Lambdas, b.thetas, eps=eps_lift)


def mean_directions(b: MeasurementBatch, eps_mass: float = C.EPS_MASS) -> torch.Tensor:
    eta = b.etas.sum(-2)
    return eta / (torch.linalg.vector_norm(eta, dim=-1, keepdim=True) + eps_mass)


def kappas(b: MeasurementBatch) -> torch.Tensor:
    return torch.linalg.vector_norm(b.etas.sum(-2), dim=-1)


def from_camera_and_surfels(
    cam_Lambdas, cam_thetas, cam_etas, cam_weights, cam_colors, cam_valid, cam_stamp,
    surf_positions, surf_Lambdas, surf_normals, surf_kappas, surf_weights, surf_stamps, surf_valid,
) -> MeasurementBatch:
    """Unified batch: camera slice passthrough + LiDAR slice from surfels
    (gray colors from normal.z)."""
    f = BELIEF_DTYPE
    dev = surf_positions.device
    n_feat = cam_Lambdas.shape[0]
    n_surf = surf_positions.shape[0]

    thetas_l = (surf_Lambdas @ surf_positions.unsqueeze(-1)).squeeze(-1)
    etas_l = surf_positions.new_zeros(n_surf, C.VMF_N_LOBES, 3)
    etas_l[:, 0, :] = surf_kappas[:, None] * surf_normals
    nz = torch.clamp(surf_normals[:, 2:3], -1.0, 1.0)
    gray = 0.25 + 0.5 * (nz + 1.0) / 2.0
    colors_l = gray.expand(n_surf, 3)

    Lambdas = torch.cat([cam_Lambdas.to(f), surf_Lambdas.to(f)], dim=0)
    thetas = torch.cat([cam_thetas.to(f), thetas_l.to(f)], dim=0)
    etas = torch.cat([cam_etas.to(f), etas_l.to(f)], dim=0)
    weights = torch.cat([cam_weights.to(f), surf_weights.to(f)], dim=0)
    sources = torch.cat([
        torch.zeros(n_feat, dtype=torch.int32, device=dev),
        torch.ones(n_surf, dtype=torch.int32, device=dev),
    ])
    valid = torch.cat([cam_valid, surf_valid], dim=0)
    stamps = torch.cat([cam_stamp.expand(n_feat).to(f), surf_stamps.to(f)], dim=0)
    colors = torch.cat([cam_colors.to(f), colors_l.to(f)], dim=0)
    vm = valid.to(f)
    return MeasurementBatch(
        Lambdas=Lambdas * vm[:, None, None],
        thetas=thetas * vm[:, None],
        etas=etas * vm[:, None, None],
        weights=weights * vm,
        sources=sources,
        valid=valid,
        timestamps=stamps,
        colors=colors,
    )
