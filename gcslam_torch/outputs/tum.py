"""TUM trajectory I/O (`timestamp x y z qx qy qz qw` per line), numpy only
(counterpart of the JAX package's outputs/tum.py)."""

from __future__ import annotations

import numpy as np


def rotvec_to_quat(rotvec: np.ndarray) -> np.ndarray:
    """(..., 3) rotvec -> (..., 4) quaternion [qx, qy, qz, qw]."""
    rotvec = np.asarray(rotvec, dtype=np.float64)
    theta = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    half = 0.5 * theta
    small = theta[..., 0] < 1e-12
    k = np.where(small[..., None], 0.5, np.sin(half) / np.where(theta == 0, 1.0, theta))
    xyz = rotvec * k
    w = np.cos(half)[..., 0]
    return np.concatenate([xyz, w[..., None]], axis=-1)


def quat_to_rotvec(q: np.ndarray) -> np.ndarray:
    """(..., 4) [qx, qy, qz, qw] -> (..., 3) rotvec."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    xyz, w = q[..., :3], q[..., 3]
    n = np.linalg.norm(xyz, axis=-1)
    theta = 2.0 * np.arctan2(n, w)
    # canonicalize to [0, pi]
    theta = np.where(theta > np.pi, theta - 2 * np.pi, theta)
    scale = np.where(n < 1e-12, 2.0, theta / np.where(n == 0, 1.0, n))
    return xyz * scale[..., None]


def write_tum(path: str, stamps: np.ndarray, poses6: np.ndarray) -> None:
    """poses6: (N, 6) [trans(3), rotvec(3)]."""
    poses6 = np.asarray(poses6, dtype=np.float64)
    q = rotvec_to_quat(poses6[:, 3:6])
    with open(path, "w") as f:
        for t, p, qi in zip(np.asarray(stamps, dtype=np.float64), poses6[:, :3], q):
            f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {qi[0]:.9f} {qi[1]:.9f} {qi[2]:.9f} {qi[3]:.9f}\n")


def read_tum(path: str):
    """-> (stamps (N,), poses6 (N, 6) [trans, rotvec])."""
    data = np.loadtxt(path).reshape(-1, 8)
    stamps = data[:, 0]
    trans = data[:, 1:4]
    rotvec = quat_to_rotvec(data[:, 4:8])
    return stamps, np.concatenate([trans, rotvec], axis=1)
