"""The step's symmetric eigensolvers, plain: the port's CUDA kernels
(eigh3, psd3, eigh_sym) replaced by their plain versions. 3 x 3 takes the
port's plain Jacobi chain (eigh3_reference, psd3_reference); other sizes
take torch.linalg.eigh, as the port's CPU route does (every use of them in
the step is invariant to the eigenvectors' signs)."""

from __future__ import annotations

from typing import Tuple

import torch

EIGH3_SWEEPS = 6


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def _rotation(app, aqq, apq):
    """(c, s, small) of the Jacobi rotation zeroing A[p, q] in the algebraic
    form of the JAX eigh_3x3: J[p, p] = J[q, q] = c, J[p, q] = s,
    J[q, p] = -s; `small` (|apq| negligible) leaves J the identity."""
    d = aqq - app
    r = torch.sqrt(d * d + 4.0 * apq * apq)
    small = apq.abs() <= 1e-24 * (app.abs() + aqq.abs() + 1e-30)
    sgn_d = torch.where(d >= 0.0, 1.0, -1.0)
    t = torch.where(small, 0.0, sgn_d * 2.0 * apq / (d.abs() + r + 1e-300))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c, small


def _jacobi_rot_3x3(A: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One batched rotation zeroing A[..., p, q]: A <- sym(J^T A J), V <- V J."""
    c, s, _ = _rotation(A[..., p, p], A[..., q, q], A[..., p, q])
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    entry = {(p, p): c, (q, q): c, (p, q): s, (q, p): -s}
    J = torch.stack([entry.get((i, j), one if i == j else zero) for i in range(3) for j in range(3)],
                    dim=-1).unflatten(-1, (3, 3))
    return _sym(J.transpose(-1, -2) @ A @ J), V @ J


def _scaled(M: torch.Tensor):
    """(sym(M) / max|sym(M)|, the scale): Jacobi is scale-invariant, and O(1)
    entries keep the rotation algebra inside the f32 exponent range."""
    A = _sym(M)
    scale = A.abs().amax(dim=(-2, -1), keepdim=True)
    scale_safe = torch.where(scale > 0.0, scale, 1.0)
    return A / scale_safe, scale_safe


def _ascending(lam: torch.Tensor, V: torch.Tensor):
    """Eigenvalues ascending, ties by index (a stable argsort), by counting
    ranks; a NaN eigenvalue gets rank 0 and duplicates an index, as in the
    JAX eigh_3x3."""
    n = lam.shape[-1]
    idx = torch.arange(n, device=lam.device)
    less = (lam[..., None, :] < lam[..., :, None]) | (
        (lam[..., None, :] == lam[..., :, None]) & (idx[None, :] < idx[:, None])
    )
    rank = less.sum(-1)
    order = torch.argmax((rank[..., None, :] == idx[:, None]).to(torch.int8), dim=-1)
    return torch.gather(lam, -1, order), torch.gather(V, -1, order[..., None, :].expand(V.shape))


def eigh3_reference(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 3 x 3 eigendecomposition by cyclic Jacobi over (0, 1),
    (0, 2), (1, 2), as a chain of batched torch ops."""
    A, scale_safe = _scaled(M)
    V = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)
    for _ in range(EIGH3_SWEEPS):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rot_3x3(A, V, p, q)
    return _ascending(torch.diagonal(A, dim1=-2, dim2=-1) * scale_safe[..., 0], V)


def psd_parts(M: torch.Tensor, eps_psd: float, eig=eigh3_reference):
    """linalg.domain_projection_psd in plain torch, with `eig` the
    eigendecomposition of sym(M): M_sym, sym_delta, eig(M_sym), the
    eigenvalue floor, M_psd = (V * vals) V^T, and the certificate; returns
    (M_psd, [projection_delta, sym_delta, eig_min, eig_max, cond,
    near_null_count]) (linalg.PsdCert's order)."""
    M_sym = _sym(M)
    sym_delta = torch.linalg.matrix_norm(M_sym - M, ord="fro")
    eigvals, eigvecs = eig(M_sym)
    vals = torch.clamp(eigvals, min=eps_psd)
    M_psd = (eigvecs * vals[..., None, :]) @ eigvecs.transpose(-1, -2)
    projection_delta = torch.linalg.matrix_norm(M_psd - M_sym, ord="fro")
    eig_min = vals.amin(-1)
    eig_max = vals.amax(-1)
    near_null = torch.sum(vals < 10.0 * eps_psd, dim=-1).to(M.dtype)
    return M_psd, [projection_delta, sym_delta, eig_min, eig_max, eig_max / eig_min, near_null]


def psd3_reference(M: torch.Tensor, eps_psd: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of psd3: psd_parts through eigh3_reference, the
    certificate fields stacked on a last axis of 6."""
    M_psd, fields = psd_parts(M, eps_psd)
    return M_psd, torch.stack(fields, -1)


def eigh3(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return eigh3_reference(M)


def psd3(M: torch.Tensor, eps_psd: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return psd3_reference(M, eps_psd)


def eigh(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if M.shape[-1] == 3:
        return eigh3_reference(M)
    return torch.linalg.eigh(M)


def eigvalsh(M: torch.Tensor) -> torch.Tensor:
    if M.shape[-1] != 3:
        return torch.linalg.eigvalsh(M)
    return eigh3_reference(M)[0]
