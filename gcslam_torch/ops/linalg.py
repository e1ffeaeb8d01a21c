"""Branch-free total-function numeric kernels (counterpart of
the JAX package's ops/linalg.py).

Every function always executes its stabilization (symmetrize, eigenvalue
floor, lift) and returns the magnitude of the change as a certificate
scalar. All functions broadcast over leading batch dims and never
synchronize with the host: a failed Cholesky yields NaN (as
`jnp.linalg.cholesky` does) instead of raising, so the NonFiniteEvidence
certificate downstream sees it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gcslam_torch import constants as C
from gcslam_torch.ops import eigh
from gcslam_torch.ops import se3
from gcslam_torch.ops.se3 import mv


class PsdCert(NamedTuple):
    projection_delta: torch.Tensor
    sym_delta: torch.Tensor
    eig_min: torch.Tensor
    eig_max: torch.Tensor
    cond: torch.Tensor
    near_null_count: torch.Tensor


def eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def domain_projection_psd(
    M: torch.Tensor, eps_psd: float = C.EPS_PSD
) -> Tuple[torch.Tensor, PsdCert]:
    """Symmetrize + eigh + eigenvalue floor + reconstruct. Always applied.
    For 3 x 3 (the JAX package's eigh_3x3 route) the whole projection is
    ops/eigh.psd3: on CUDA one kernel launch (the 3 x 3 Jacobi with the
    floor, the reconstruction and the certificate fused), on the CPU its
    plain composition. Other sizes take ops/eigh.eigh (the fixed-sweep
    kernel on CUDA, LAPACK on the CPU) and the same epilogue in torch
    (ops/eigh.psd_parts)."""
    if M.shape[-2:] == (3, 3):
        M_psd, cert = eigh.psd3(M, eps_psd)
        return M_psd, PsdCert(*cert.unbind(-1))
    M_psd, fields = eigh.psd_parts(M, eps_psd, eigh.eigh)
    return M_psd, PsdCert(*fields)


def _lift_eps(L: torch.Tensor, eps_lift: float) -> torch.Tensor:
    """eps_lift plus a relative ridge of 32 machine epsilons x max|diag|."""
    diag_scale = torch.diagonal(L, dim1=-2, dim2=-1).abs().amax(-1)
    rel = 32.0 * torch.finfo(L.dtype).eps * diag_scale
    return (eps_lift + rel)[..., None, None]


def _cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN-filled where A is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], chol, torch.nan)


def spd_solve_lifted(
    L: torch.Tensor, b: torch.Tensor, eps_lift: float = C.EPS_LIFT
) -> Tuple[torch.Tensor, float]:
    """x = (L + eps I)^{-1} b via Cholesky; returns (x, lift_strength)."""
    d = L.shape[-1]
    vec = b.dim() == L.dim() - 1
    if d == 3 and vec:
        return solve3x3(L, b, eps=eps_lift), eps_lift * d
    chol = _cholesky_nan(L + _lift_eps(L, eps_lift) * eye(d, L))
    b_mat = b.unsqueeze(-1) if vec else b
    y = torch.linalg.solve_triangular(chol, b_mat, upper=False)
    x = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
    return (x.squeeze(-1) if vec else x), eps_lift * d


def spd_inverse_lifted(L: torch.Tensor, eps_lift: float = C.EPS_LIFT) -> Tuple[torch.Tensor, float]:
    """(L + eps I)^{-1} via Cholesky; 3x3 blocks use the adjugate inverse."""
    d = L.shape[-1]
    if d == 3:
        return sym(inv3x3(L, eps=eps_lift)), eps_lift * d
    chol = _cholesky_nan(L + _lift_eps(L, eps_lift) * eye(d, L))
    I = eye(d, L).expand(L.shape)
    chol_inv = torch.linalg.solve_triangular(chol, I, upper=False)
    return chol_inv.transpose(-1, -2) @ chol_inv, eps_lift * d


def inv_mass(m: torch.Tensor, eps_mass: float = C.EPS_MASS) -> Tuple[torch.Tensor, torch.Tensor]:
    """1/(m + eps) and the epsilon ratio; total even for m <= 0."""
    denom = m + eps_mass + torch.finfo(m.dtype).eps
    return 1.0 / denom, eps_mass / denom


def clamp(x: torch.Tensor, lo: float, hi: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x clipped to [lo, hi] and how far each entry moved."""
    clamped = torch.clamp(x, lo, hi)
    return clamped, torch.abs(clamped - x)


def safe_normalize(v: torch.Tensor, eps: float = C.EPS_MASS) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    denom = norm + eps
    return v / denom, (eps / denom)[..., 0]


def eigh_3x3(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric 3x3 eigendecomposition by 6 sweeps of cyclic Jacobi
    (ascending eigenvalues; ties ordered by index like a stable argsort):
    ops/eigh.eigh3, the kernel on CUDA tensors and the plain chain on CPU
    tensors."""
    return eigh.eigh3(M)


def softplus_positive(x: torch.Tensor, eps: float = 1e-12, beta: float = 50.0) -> torch.Tensor:
    return _softplus(beta * x) / beta + eps


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log1p(exp(x)) in the overflow-safe form jax.nn.softplus uses
    return torch.logaddexp(x, torch.zeros_like(x))


def smooth_interval_project(x: torch.Tensor, lo: torch.Tensor, hi: float) -> torch.Tensor:
    floored = lo + _softplus(x - lo)
    return hi - _softplus(hi - floored)


def det3x3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Scale-normalized adjugate inverse of (..., 3, 3) with an optional
    +eps*I lift and a relative, sign-preserving determinant floor: the
    custom operator gcslam::inv3x3, one launch of csrc/se3.cu on a CUDA
    tensor (se3.launch), inv3x3_reference on a CPU tensor."""
    return _inv3x3_op(M, float(eps))


def inv3x3_reference(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """The plain version of inv3x3."""
    s = M.abs().amax(dim=(-2, -1), keepdim=True)
    s = torch.where(s > 0.0, s, 1.0)
    eps_rel = 32.0 * torch.finfo(M.dtype).eps
    M = M / s + (eps / s + eps_rel) * eye(3, M)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * Cc
    floor = max(1e-30, (32.0 * torch.finfo(M.dtype).eps) ** 3)
    sgn = torch.where(det >= 0.0, 1.0, -1.0)
    inv_det = 1.0 / torch.where(det.abs() > floor, det, sgn * floor)
    adjT = torch.stack(
        [
            torch.stack([A, D, G], dim=-1),
            torch.stack([B, E, H], dim=-1),
            torch.stack([Cc, F, I], dim=-1),
        ],
        dim=-2,
    )
    return adjT * (inv_det[..., None, None] / s)


@torch.library.custom_op("gcslam::inv3x3", mutates_args=(), device_types="cpu")
def _inv3x3_op(M: torch.Tensor, eps: float) -> torch.Tensor:
    return inv3x3_reference(M, eps)


@_inv3x3_op.register_kernel("cuda")
def _inv3x3_cuda(M, eps):
    return se3.launch("inv3x3", M, None, eps)


@_inv3x3_op.register_vmap
def _inv3x3_vmap(info, in_dims, M, eps):
    """The vmapped dim leads the batch: one call (on CUDA one launch)."""
    return _inv3x3_op(M.movedim(in_dims[0], 0), eps), 0


def solve3x3(M: torch.Tensor, b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return mv(inv3x3(M, eps), b)


def rotation_from_scatter(S: torch.Tensor):
    """Nearest proper rotation + generalized singular values + right
    singular vectors of a 3x3 scatter, via eigh(S^T S)."""
    B = sym(S.transpose(-1, -2) @ S)
    lam, V = eigh_3x3(B)
    lam = lam.flip(-1)
    V = V.flip(-1)
    detV = det3x3(V)
    col_sign = torch.cat([torch.ones_like(V[..., 0, :2]), torch.where(detV < 0, -1.0, 1.0)[..., None]], dim=-1)
    V = V * col_sign[..., None, :]
    sigma = torch.sqrt(torch.clamp(lam, min=0.0))
    floor = torch.clamp(1e-9 * sigma[..., :1], min=1e-20)
    U_raw = S @ (V / torch.maximum(sigma[..., None, :], floor[..., None, :]))
    u1, _ = safe_normalize(U_raw[..., :, 0])
    u2_raw = U_raw[..., :, 1] - torch.sum(u1 * U_raw[..., :, 1], -1, keepdim=True) * u1
    u2, _ = safe_normalize(u2_raw)
    u3 = torch.linalg.cross(u1, u2)
    U = torch.stack([u1, u2, u3], dim=-1)
    R_star = U @ V.transpose(-1, -2)
    D = torch.diagonal(U.transpose(-1, -2) @ S @ V, dim1=-2, dim2=-1)
    return R_star, D, V


def set_slice(v: torch.Tensor, x: torch.Tensor, sl: slice) -> torch.Tensor:
    """Copy of `v` with v[..., sl] = x, leading dims broadcast. Out of
    place, so that it runs under torch.func.vmap with `x` batched and `v`
    not (an in-place write into an unbatched tensor cannot take a batched
    value)."""
    batch = torch.broadcast_shapes(v.shape[:-1], x.shape[:-1])
    v = v.expand(batch + v.shape[-1:])
    x = x.expand(batch + x.shape[-1:])
    return torch.slice_scatter(v, x, dim=-1, start=sl.start, end=sl.stop)


def set_block(M: torch.Tensor, block: torch.Tensor, rows: slice, cols: slice) -> torch.Tensor:
    """Copy of `M` with M[..., rows, cols] = block, leading dims broadcast
    (out of place, as set_slice)."""
    batch = torch.broadcast_shapes(M.shape[:-2], block.shape[:-2])
    M = M.expand(batch + M.shape[-2:])
    band = set_slice(M[..., rows, :], block.expand(batch + block.shape[-2:]), cols)
    return torch.slice_scatter(M, band, dim=-2, start=rows.start, end=rows.stop)


def add_block(M: torch.Tensor, block: torch.Tensor, rows: slice, cols: slice) -> torch.Tensor:
    """Copy of `M` with `block` added to M[..., rows, cols] (the entries
    outside keep their bits)."""
    return set_block(M, M[..., rows, cols] + block, rows, cols)


def embed_block(block: torch.Tensor, vec: torch.Tensor, sl: slice, d: int = C.D_Z):
    """Zero (..., d, d) / (..., d) factor with `block`/`vec` in the slice
    `sl` (leading batch dims broadcast)."""
    L = set_block(block.new_zeros(d, d), block, sl, sl)
    h = set_slice(vec.new_zeros(d), vec, sl)
    batch = torch.broadcast_shapes(L.shape[:-2], h.shape[:-1])
    return L.expand(batch + (d, d)), h.expand(batch + (d,))
