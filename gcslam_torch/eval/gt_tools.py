"""Ground-truth tooling: overlap checks + format conversion (counterpart of
the JAX package's eval/gt_tools.py; reference tools/align_ground_truth.py,
kimera_gt_to_tum.py, gt_checks.py). Pure NumPy."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from gcslam_torch.outputs.tum import quat_to_rotvec, write_tum


def check_time_overlap(est_stamps: np.ndarray, gt_stamps: np.ndarray,
                       min_overlap_frac: float = 0.5) -> Dict:
    """Gate: the estimate's time span must overlap the GT span
    (tools/align_ground_truth.py / tools/tests/test_eval_ground_truth.py)."""
    e0, e1 = float(est_stamps.min()), float(est_stamps.max())
    g0, g1 = float(gt_stamps.min()), float(gt_stamps.max())
    lo, hi = max(e0, g0), min(e1, g1)
    overlap = max(0.0, hi - lo)
    est_span = max(e1 - e0, 1e-9)
    frac = overlap / est_span
    return {
        "est_span": (e0, e1),
        "gt_span": (g0, g1),
        "overlap_sec": overlap,
        "overlap_frac_of_est": frac,
        "pass": frac >= min_overlap_frac,
    }


def interpolate_gt(gt_stamps: np.ndarray, gt_poses: np.ndarray,
                   query_stamps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Linear-in-translation / nearest-in-rotation GT resampling onto the
    estimate's stamps. Returns (poses (N, 6), valid mask)."""
    q = np.asarray(query_stamps)
    valid = (q >= gt_stamps.min()) & (q <= gt_stamps.max())
    out = np.zeros((len(q), 6))
    for i in range(3):
        out[:, i] = np.interp(q, gt_stamps, gt_poses[:, i])
    idx = np.clip(np.searchsorted(gt_stamps, q), 0, len(gt_stamps) - 1)
    out[:, 3:6] = gt_poses[idx, 3:6]
    return out, valid


def csv_gt_to_tum(csv_path: str, out_path: str, stamp_scale: float = 1e-9) -> int:
    """Convert a Kimera-style GT csv
    (timestamp_ns, x, y, z, qw, qx, qy, qz[, ...]) to TUM
    (reference tools/kimera_gt_to_tum.py)."""
    rows = np.loadtxt(csv_path, delimiter=",", skiprows=1)
    stamps = rows[:, 0] * stamp_scale
    trans = rows[:, 1:4]
    q_wxyz = rows[:, 4:8]
    q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
    rotvec = quat_to_rotvec(q_xyzw)
    write_tum(out_path, stamps, np.concatenate([trans, rotvec], axis=1))
    return len(stamps)
