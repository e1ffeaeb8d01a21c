"""Batched, branch-free SO(3)/SE(3) Lie ops (counterpart of the JAX package's ops/se3.py).

6D pose = [trans(3), rotvec(3)]; small-angle Taylor blends via torch.where;
near-pi handling through a softmax-weighted axis extraction in so3_log.
Every function broadcasts over arbitrary leading batch dims and keeps the
input dtype.
"""

from __future__ import annotations

import torch

SMALL_ANGLE = 1e-7


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcasting matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[v]x for (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of skew for (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta(phi: torch.Tensor):
    theta_sq = torch.sum(phi * phi, dim=-1)
    return torch.sqrt(theta_sq), theta_sq


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotvec -> (..., 3, 3) rotation."""
    theta, theta_sq = _theta(omega)
    K = skew(omega)
    K_sq = K @ K
    small = theta < SMALL_ANGLE
    safe_t = torch.where(small, 1.0, theta)
    safe_t2 = torch.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    A = torch.where(small, 1.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5, (1.0 - torch.cos(safe_t)) / safe_t2)
    return eye3(omega) + A[..., None, None] * K + B[..., None, None] * K_sq


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3) rotvec (small-angle /
    generic / near-pi blend, same formulas as the JAX package)."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    vex = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.linalg.vector_norm(vex, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)

    omega_small = vex
    safe_sin = torch.where(sin_theta < SMALL_ANGLE, 1.0, sin_theta)
    omega_general = (theta / safe_sin)[..., None] * vex

    S_sym = 0.5 * (R + R.transpose(-1, -2))
    one_minus_c = torch.clamp(1.0 - cos_theta, min=SMALL_ANGLE)[..., None, None]
    outer = (S_sym - cos_theta[..., None, None] * eye3(R)) / one_minus_c
    diag = torch.diagonal(outer, dim1=-2, dim2=-1)
    w = torch.softmax(50.0 * diag, dim=-1)
    axis_col = mv(outer, w)
    axis_norm = torch.linalg.vector_norm(axis_col, dim=-1, keepdim=True)
    safe_norm = torch.where(axis_norm < SMALL_ANGLE, 1.0, axis_norm)
    axis = axis_col / safe_norm
    sign = torch.where(torch.sum(axis * vex, dim=-1, keepdim=True) >= 0.0, 1.0, -1.0)
    omega_pi = axis * sign * theta[..., None]

    is_small = (theta < SMALL_ANGLE)[..., None]
    is_near_pi = ((cos_theta < 0.0) & (sin_theta < 1e-5))[..., None]
    return torch.where(is_small, omega_small, torch.where(is_near_pi, omega_pi, omega_general))


def _BC_coeffs(theta, theta_sq):
    small = theta < SMALL_ANGLE
    safe_t = torch.where(small, 1.0, theta)
    safe_t2 = torch.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    safe_t3 = safe_t2 * safe_t
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (safe_t - torch.sin(safe_t)) / safe_t3)
    return B, C


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Jr(phi) = I - B [phi]x + C [phi]x^2 (reference se3_jax.py:68-103)."""
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    B, C = _BC_coeffs(theta, theta_sq)
    return eye3(phi) - B[..., None, None] * K + C[..., None, None] * (K @ K)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Jr^{-1}(phi) = I + 1/2 [phi]x + D [phi]x^2 (reference se3_jax.py:107-134)."""
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    eps = 1e-12
    denom = 2.0 * theta * torch.sin(theta) + eps
    D = torch.where(
        theta < 1e-4,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / (theta_sq + eps) - (1.0 + torch.cos(theta)) / denom,
    )
    return eye3(phi) + 0.5 * K + D[..., None, None] * (K @ K)


def se3_V(phi: torch.Tensor) -> torch.Tensor:
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    B, C = _BC_coeffs(theta, theta_sq)
    return eye3(phi) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def se3_V_inv(phi: torch.Tensor) -> torch.Tensor:
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    eps = 1e-12
    small = theta < SMALL_ANGLE
    safe_t = torch.where(small, 1.0, theta)
    safe_t2 = torch.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    denom = 2.0 * safe_t * torch.sin(safe_t) + eps
    D = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / safe_t2 - (1.0 + torch.cos(safe_t)) / denom,
    )
    return eye3(phi) - 0.5 * K + D[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rho, phi] -> 6D pose [t, rotvec] with t = V(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    return torch.cat([mv(se3_V(phi), rho), phi], dim=-1)


def se3_log(pose: torch.Tensor) -> torch.Tensor:
    t, rotvec = pose[..., :3], pose[..., 3:6]
    phi = so3_log(so3_exp(rotvec))
    return torch.cat([mv(se3_V_inv(phi), t), phi], dim=-1)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T_a o T_b for 6D poses [t, rotvec]."""
    Ra = so3_exp(a[..., 3:6])
    Rb = so3_exp(b[..., 3:6])
    t = a[..., :3] + mv(Ra, b[..., :3])
    return torch.cat([t, so3_log(Ra @ Rb)], dim=-1)


def se3_inverse(a: torch.Tensor) -> torch.Tensor:
    R_inv = so3_exp(a[..., 3:6]).transpose(-1, -2)
    return torch.cat([-mv(R_inv, a[..., :3]), so3_log(R_inv)], dim=-1)


def se3_relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b^{-1} o a."""
    return se3_compose(se3_inverse(b), a)


def se3_plus(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Retraction: T(x) o T(delta) where delta is a 6D pose increment."""
    return se3_compose(x, delta)


def se3_minus(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """delta such that x2 (+) delta = x1 (pose difference, not twist)."""
    return se3_relative(x1, x2)


def se3_adjoint(xi: torch.Tensor) -> torch.Tensor:
    """Ad_T (6x6) for pose [t, rotvec] acting on twists [rho, phi]:
    Ad = [[R, [t]x R], [0, R]], so that Exp(Ad_T xi) = T Exp(xi) T^{-1}."""
    R = so3_exp(xi[..., 3:6])
    tR = skew(xi[..., :3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_cov_compose(cov_a: torch.Tensor, cov_b: torch.Tensor, T_a: torch.Tensor) -> torch.Tensor:
    """Compose covariances under T_out = T_a o T_b."""
    Ad = se3_adjoint(T_a)
    return cov_a + Ad @ cov_b @ Ad.transpose(-1, -2)


def se3_identity(dtype=None, device=None) -> torch.Tensor:
    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    return torch.zeros(6, dtype=dtype or BELIEF_DTYPE, device=device)


def apply_pose_to_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """p' = R p + t for pose (..., 6) and points (..., N, 3)."""
    R = so3_exp(pose[..., 3:6])
    return torch.einsum("...ij,...nj->...ni", R, points) + pose[..., None, :3]
