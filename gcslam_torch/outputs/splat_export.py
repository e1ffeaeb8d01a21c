"""Splat export: the atlas as renderable Gaussian-splat arrays in one
`splat_export.npz` (counterpart of the JAX package's
outputs/splat_export.py)."""

from __future__ import annotations

import numpy as np
import torch

from gcslam_torch.ops import linalg


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def atlas_to_splats(atlas) -> dict:
    """Flatten valid primitives to export arrays: positions, covariances,
    precisions, lobes, kappas, colours, masses, ids, tile ids."""
    valid = _np(atlas.valid)  # (T, M)
    # Precision-collapsed primitives (Lambda decayed to ~underflow in tiles
    # that left the active stencil before the cull could run) carry no
    # information and their solved mu overflows: excluded, as the map's
    # own cull (models/atlas.LAMBDA_CULL_FLOOR) excludes them.
    lam_all = _np(atlas.Lambdas)
    lam_diag = np.abs(np.diagonal(lam_all, axis1=-2, axis2=-1))
    valid = valid & (lam_diag.max(axis=-1) > 1e-12)
    idx = np.argwhere(valid)
    ti, si = idx[:, 0], idx[:, 1]

    Lam = lam_all[ti, si].astype(np.float64)
    th = _np(atlas.thetas)[ti, si].astype(np.float64)
    Sigma = _np(linalg.inv3x3(torch.as_tensor(Lam), eps=1e-9))
    mu = np.einsum("nij,nj->ni", Sigma, th)
    etas = _np(atlas.etas)[ti, si].astype(np.float64)
    eta_sum = etas.sum(axis=1)
    kap = np.linalg.norm(eta_sum, axis=1)

    return {
        "mu_world": mu,
        "Sigma_world": Sigma,
        "Lambda_world": Lam,
        "etas": etas,
        "kappas": kap,
        "normals": eta_sum / np.maximum(kap[:, None], 1e-12),
        "colors": _np(atlas.rgb)[ti, si].astype(np.float64),
        "masses": _np(atlas.weights)[ti, si].astype(np.float64),
        "primitive_ids": _np(atlas.primitive_ids)[ti, si],
        "tile_ids": _np(atlas.tile_ids)[ti],
        "cam_mass": _np(atlas.cam_mass)[ti, si].astype(np.float64),
        "lidar_mass": _np(atlas.lidar_mass)[ti, si].astype(np.float64),
        "created": _np(atlas.created)[ti, si].astype(np.float64),
        "last_supported_scan_seq": _np(atlas.last_supported)[ti, si],
    }


def save_splat_export(path: str, atlas) -> int:
    """Write the atlas's splats to `path` (npz); returns the splat count."""
    data = atlas_to_splats(atlas)
    np.savez_compressed(path, **data)
    return int(data["mu_world"].shape[0])
