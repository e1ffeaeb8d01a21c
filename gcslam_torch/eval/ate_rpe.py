"""Trajectory ATE (counterpart of the JAX package's eval/ate_rpe.py: compute_ate
and what it calls). Pure NumPy; poses are (N, 6) [trans, rotvec]."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _rotvec_to_R(rv: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rv, axis=-1, keepdims=True)
    k = np.where(theta > 1e-12, rv / np.where(theta == 0, 1.0, theta), 0.0)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    return np.eye(3) + st * K + (1 - ct) * (K @ K)


def _R_to_rotvec(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip(0.5 * (tr - 1), -1, 1)
    vex = 0.5 * np.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        axis=-1,
    )
    sin = np.linalg.norm(vex, axis=-1)
    theta = np.arctan2(sin, cos)
    scale = np.where(sin > 1e-9, theta / np.where(sin == 0, 1, sin), 1.0)
    rv = vex * scale[..., None]
    # near theta = pi the vex-scaled formula degenerates: recover the axis
    # from the symmetric part R ~ 2 a a^T - I
    near_pi = (cos < -0.99) & (sin <= 1e-6)
    if np.any(near_pi):
        diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
        a = np.sqrt(np.maximum(0.0, (diag + 1.0) / 2.0))
        k = np.argmax(a, axis=-1)
        sgn = np.sign(
            np.stack(
                [
                    0.5 * (R[..., 0, 1] + R[..., 1, 0]),
                    0.5 * (R[..., 1, 2] + R[..., 2, 1]),
                    0.5 * (R[..., 0, 2] + R[..., 2, 0]),
                ],
                axis=-1,
            )
        )
        s0 = np.where(k == 0, 1.0, np.where(k == 1, sgn[..., 0], sgn[..., 2]))
        s1 = np.where(k == 1, 1.0, np.where(k == 0, sgn[..., 0], sgn[..., 1]))
        s2 = np.where(k == 2, 1.0, np.where(k == 1, sgn[..., 1], sgn[..., 2]))
        s = np.stack([s0, s1, s2], axis=-1)
        s = np.where(s == 0, 1.0, s)
        axis = a * s
        nrm = np.linalg.norm(axis, axis=-1, keepdims=True)
        axis = axis / np.where(nrm == 0, 1.0, nrm)
        rv = np.where(near_pi[..., None], axis * theta[..., None], rv)
    return rv


def align_initial_pose(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Left-multiply est by gt0 * est0^{-1} so the first poses coincide."""
    R_e0 = _rotvec_to_R(est[0, 3:6])
    R_g0 = _rotvec_to_R(gt[0, 3:6])
    R_fix = R_g0 @ R_e0.T
    t_fix = gt[0, :3] - R_fix @ est[0, :3]
    R_new = np.einsum("ij,njk->nik", R_fix, _rotvec_to_R(est[:, 3:6]))
    t_new = np.einsum("ij,nj->ni", R_fix, est[:, :3]) + t_fix
    return np.concatenate([t_new, _R_to_rotvec(R_new)], axis=1)


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> np.ndarray:
    """Closed-form similarity alignment of trajectories (Umeyama 1991)."""
    x = est[:, :3].T
    y = gt[:, :3].T
    mx, my = x.mean(1, keepdims=True), y.mean(1, keepdims=True)
    xc, yc = x - mx, y - my
    U, d, Vt = np.linalg.svd(yc @ xc.T / x.shape[1])
    Sfix = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sfix[2, 2] = -1
    R = U @ Sfix @ Vt
    c = 1.0
    if with_scale:
        c = np.trace(np.diag(d) @ Sfix) / (xc**2).sum() * x.shape[1]
    t = my[:, 0] - c * R @ mx[:, 0]
    R_new = np.einsum("ij,njk->nik", R, _rotvec_to_R(est[:, 3:6]))
    t_new = c * np.einsum("ij,nj->ni", R, est[:, :3]) + t
    return np.concatenate([t_new, _R_to_rotvec(R_new)], axis=1)


def _stats(err: np.ndarray) -> Dict[str, float]:
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "max": float(np.max(err)),
    }


def compute_ate(est: np.ndarray, gt: np.ndarray, align: str = "initial") -> Dict:
    """ATE after alignment ('initial' | 'umeyama' | 'none')."""
    if align == "initial":
        est = align_initial_pose(est, gt)
    elif align == "umeyama":
        est = umeyama_alignment(est, gt)
    t_err = np.linalg.norm(est[:, :3] - gt[:, :3], axis=1)
    R_rel = np.einsum("nij,nkj->nik", _rotvec_to_R(gt[:, 3:6]), _rotvec_to_R(est[:, 3:6]))
    r_err = np.degrees(np.abs(np.linalg.norm(_R_to_rotvec(R_rel), axis=1)))
    per_axis = {ax: _stats(np.abs(est[:, i] - gt[:, i])) for i, ax in enumerate("xyz")}
    return {
        "translation": _stats(t_err),
        "rotation_deg": _stats(r_err),
        "per_axis": per_axis,
        "align": align,
        "rot_offset_180_suspect": bool(float(np.median(r_err)) > 150.0),
        "n_poses": int(est.shape[0]),
    }
