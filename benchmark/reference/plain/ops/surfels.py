"""LiDAR surfel extraction — scatter-add moment accumulation + batched 3x3
plane fits (counterpart of the JAX package's ops/surfels.py).

Deskewed points -> <= n_surfel surfels on a fixed 32x32x8 MA-Hex-3D hash
grid (modulo wrap): per-point weighted moments (w, w p, w p p^T, w t)
accumulate per cell in one deterministic scatter-add, the first n_surfel
valid cells by cell id are compacted by rank, and each gets a plane fit,
Gaussian covariance with sensor noise, Wishart regularization in precision
space and kappa = scale / sigma_perp. Points in f32, plane algebra in f64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.ops.binned import scatter_accumulate, scatter_set
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS
from benchmark.reference.plain.utils.dtypes import BELIEF_DTYPE, POINT_DTYPE, TIME_DTYPE

N_CELLS_1 = 32
N_CELLS_2 = 32
N_CELLS_Z = 8
N_CELLS = N_CELLS_1 * N_CELLS_2 * N_CELLS_Z
SQRT3_2 = 0.8660254037844386

SENSOR_VAR = 1e-6
WISHART_NU = 5.0
WISHART_PSI = 0.1
KAPPA_SCALE = 10.0
KAPPA_MIN = 0.1
KAPPA_MAX = 100.0
EIG_MIN = 1e-12


class SurfelSet(NamedTuple):
    positions: torch.Tensor  # (n_surfel, 3) body frame
    Lambdas: torch.Tensor  # (n_surfel, 3, 3)
    normals: torch.Tensor  # (n_surfel, 3)
    kappas: torch.Tensor  # (n_surfel,)
    weights: torch.Tensor  # (n_surfel,)
    timestamps: torch.Tensor  # (n_surfel,)
    valid: torch.Tensor  # (n_surfel,) bool
    n_valid: torch.Tensor  # ()


def extract_surfels(
    points: torch.Tensor,  # (N, 3)
    timestamps: torch.Tensor,  # (N,)
    weights: torch.Tensor,  # (N,)
    n_surfel: int = C.N_SURFEL,
    voxel_size_m: float = 0.1,
    min_points: int = 3,
    sensor_var: torch.Tensor = None,
) -> tuple[SurfelSet, Cert]:
    """`sensor_var`: adapted isotropic sensor noise variance (floored at
    SENSOR_VAR); None keeps the datasheet constant."""
    f32 = POINT_DTYPE
    dev = points.device
    pts = points.to(f32)
    w = weights.to(f32)
    t_ref = timestamps.amax()
    t = (timestamps - t_ref).to(f32)

    finite = torch.all(pts.abs() < 0.1 * C.NONFINITE_SENTINEL, dim=-1)
    w = w * finite.to(f32)

    w_sum_all = w.sum() + EIG_MIN
    center = torch.sum(pts * w[:, None], dim=0) / w_sum_all
    p_c = pts - center[None, :]

    h = max(float(voxel_size_m), 1e-12)
    s1 = p_c[:, 0]
    s2 = p_c[:, 0] * 0.5 + p_c[:, 1] * SQRT3_2
    c1 = torch.remainder(torch.floor(s1 / h).to(torch.int32), N_CELLS_1)
    c2 = torch.remainder(torch.floor(s2 / h).to(torch.int32), N_CELLS_2)
    cz = torch.remainder(torch.floor(p_c[:, 2] / h).to(torch.int32), N_CELLS_Z)
    cell = c1 * (N_CELLS_2 * N_CELLS_Z) + c2 * N_CELLS_Z + cz
    cell = torch.where(w > 0, cell, N_CELLS)  # zero-weight points drop

    outer = p_c[:, :, None] * p_c[:, None, :]
    moments15 = torch.cat(
        [
            w[:, None],
            w[:, None] * p_c,
            (w[:, None, None] * outer).reshape(-1, 9),
            (w * t)[:, None],
            (w > 0).to(f32)[:, None],
        ],
        dim=1,
    )
    acc = scatter_accumulate(cell, moments15, N_CELLS)
    m0 = acc[:, 0]
    m1 = acc[:, 1:4]
    m2 = acc[:, 4:13].reshape(-1, 3, 3)
    mt = acc[:, 13]
    count = acc[:, 14]

    # Valid cells first, by cell id: scatter each valid cell to its rank.
    cell_ids = torch.arange(N_CELLS, dtype=torch.int64, device=dev)
    cell_valid = (count >= float(min_points)) & (m0 > 0)
    rank = torch.cumsum(cell_valid.to(torch.int64), 0) - 1
    tgt = torch.where(cell_valid & (rank < n_surfel), rank, n_surfel)
    take = scatter_set(torch.zeros(n_surfel, dtype=torch.int64, device=dev), tgt, cell_ids)
    slot_valid = scatter_set(torch.zeros(n_surfel, dtype=torch.bool, device=dev), tgt, cell_valid)
    n_valid = slot_valid.sum()

    f64 = BELIEF_DTYPE
    m0_s = m0[take].to(f64)
    m1_s = m1[take].to(f64)
    m2_s = m2[take].to(f64)
    mt_s = mt[take].to(f64)
    inv_m0 = 1.0 / torch.clamp(m0_s, min=EIG_MIN)

    centroid_c = m1_s * inv_m0[:, None]
    cov = m2_s * inv_m0[:, None, None] - centroid_c[:, :, None] * centroid_c[:, None, :]
    cov = linalg.sym(cov) + EIG_MIN * linalg.eye(3, cov)

    eigvals, eigvecs = linalg.eigh_3x3(cov)
    normal = eigvecs[:, :, 0]
    normal = normal * torch.where(normal[:, 2:3] < 0.0, -1.0, 1.0)
    sigma_perp_sq = torch.clamp(eigvals[:, 0], min=EIG_MIN)

    s_var = SENSOR_VAR if sensor_var is None else torch.clamp(sensor_var.to(f64), min=SENSOR_VAR)
    vals = torch.clamp(eigvals, min=EIG_MIN) + s_var
    Sigma = (eigvecs * vals[:, None, :]) @ eigvecs.transpose(-1, -2)

    Lambda = linalg.inv3x3(Sigma, eps=EIG_MIN)
    Lambda_reg = linalg.sym(Lambda) + (WISHART_NU / WISHART_PSI) * linalg.eye(3, Lambda)

    kappa = torch.clamp(KAPPA_SCALE / torch.sqrt(sigma_perp_sq), KAPPA_MIN, KAPPA_MAX)

    vmask = slot_valid.to(f64)
    positions = (centroid_c + center.to(f64)[None, :]) * vmask[:, None]
    surfels = SurfelSet(
        positions=positions,
        Lambdas=Lambda_reg * vmask[:, None, None] + (1.0 - vmask)[:, None, None] * linalg.eye(3, Lambda),
        normals=normal * vmask[:, None],
        kappas=kappa * vmask,
        weights=m0_s * vmask,
        timestamps=(t_ref + (mt_s * inv_m0).to(TIME_DTYPE)) * vmask,
        valid=slot_valid,
        n_valid=n_valid,
    )
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["ma_hex3d_binning"] | TRIGGERS["plane_fit_batched"]
        | TRIGGERS["wishart_regularization"],
        ess_total=n_valid.to(f64),
        support_frac=n_valid.to(f64) / float(max(n_surfel, 1)),
    )
    return surfels, cert
