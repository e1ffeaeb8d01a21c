"""Trajectory metrics (counterpart of the JAX package's eval/ate_rpe.py): ATE
(translation + rotation) after initial-pose or Umeyama alignment, and RPE
over 1/5/10 m path windows. Pure NumPy; poses are (N, 6) [trans, rotvec]."""

from __future__ import annotations

from typing import Dict, List

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


def _compose(a_R, a_t, b_R, b_t):
    return a_R @ b_R, (a_R @ b_t[..., None])[..., 0] + a_t


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


def compute_rpe(est: np.ndarray, gt: np.ndarray, deltas_m: List[float] = (1.0, 5.0, 10.0)) -> Dict:
    """Relative pose error over path-length windows (multi-scale)."""
    gt_t = gt[:, :3]
    cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(gt_t, axis=0), axis=1))])
    R_e = _rotvec_to_R(est[:, 3:6])
    R_g = _rotvec_to_R(gt[:, 3:6])
    out = {}
    for delta in deltas_m:
        terrs, rerrs = [], []
        for i in range(len(est)):
            j = int(np.searchsorted(cum, cum[i] + delta))
            if j >= len(est):
                break
            dR_g = R_g[i].T @ R_g[j]
            dt_g = R_g[i].T @ (gt_t[j] - gt_t[i])
            dR_e = R_e[i].T @ R_e[j]
            dt_e = R_e[i].T @ (est[j, :3] - est[i, :3])
            terrs.append(np.linalg.norm(dt_e - dt_g))
            rerrs.append(np.degrees(np.linalg.norm(_R_to_rotvec(dR_e @ dR_g.T))))
        key = f"{delta:g}m"
        if terrs:
            out[key] = {"translation": _stats(np.asarray(terrs)), "rotation_deg": _stats(np.asarray(rerrs)),
                        "n_pairs": len(terrs)}
        else:
            out[key] = {"translation": None, "rotation_deg": None, "n_pairs": 0}
    return out
