"""ScanBatch: one scan's fixed-shape sensor inputs as tensors (counterpart
of the JAX package's models/scan_io.py).

Every field has a static shape set by the budgets; validity lives in
weights/masks, never in shapes. `batch_from_numpy` takes the JAX package's
ScanBatch given as a tree of numpy arrays or tensors (any object with the
fields as attributes, or a mapping) and returns the port's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gcslam_torch import constants as C
from gcslam_torch.utils.device import resolve_device
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, POINT_DTYPE, TIME_DTYPE


class ScanBatch(NamedTuple):
    # LiDAR (padded rows carry zero weight)
    points: torch.Tensor  # (N_POINTS_CAP, 3) POINT_DTYPE, base frame
    point_stamps: torch.Tensor  # (N_POINTS_CAP,) TIME_DTYPE
    point_weights: torch.Tensor  # (N_POINTS_CAP,) POINT_DTYPE
    point_ring: torch.Tensor  # (N_POINTS_CAP,) int32
    point_tag: torch.Tensor  # (N_POINTS_CAP,) int32
    # IMU window (zero-padded stamps mark invalid samples)
    imu_stamps: torch.Tensor  # (MAX_IMU_PREINT_LEN,) TIME_DTYPE
    imu_gyro: torch.Tensor  # (MAX_IMU_PREINT_LEN, 3)
    imu_accel: torch.Tensor  # (MAX_IMU_PREINT_LEN, 3)
    # Odometry (closest to scan)
    odom_pose: torch.Tensor  # (6,) [trans, rotvec]
    odom_cov: torch.Tensor  # (6, 6)
    odom_twist: torch.Tensor  # (6,) [v(3), omega(3)] body frame
    odom_twist_cov: torch.Tensor  # (6, 6)
    odom_rel_pose: torch.Tensor  # (6,)
    odom_rel_cov: torch.Tensor  # (6, 6)
    # Camera measurement slice (zeros unless with_camera)
    cam_Lambdas: torch.Tensor  # (N_FEAT, 3, 3)
    cam_thetas: torch.Tensor  # (N_FEAT, 3)
    cam_etas: torch.Tensor  # (N_FEAT, VMF_N_LOBES, 3)
    cam_weights: torch.Tensor  # (N_FEAT,)
    cam_colors: torch.Tensor  # (N_FEAT, 3)
    cam_valid: torch.Tensor  # (N_FEAT,) bool
    # Loop closure (loop_weight = 0 => absent)
    loop_pose: torch.Tensor  # (6,)
    loop_cov: torch.Tensor  # (6, 6)
    loop_weight: torch.Tensor  # ()
    # Scan clock
    scan_start_time: torch.Tensor  # () TIME_DTYPE
    scan_end_time: torch.Tensor  # () TIME_DTYPE
    t_scan: torch.Tensor  # () TIME_DTYPE
    t_last_scan: torch.Tensor  # () TIME_DTYPE
    dt_sec: torch.Tensor  # () BELIEF_DTYPE
    scan_seq: torch.Tensor  # () int32

    def to(self, device) -> "ScanBatch":
        return ScanBatch(*[x.to(device) for x in self])


# dtype of every field, for conversion from numpy
FIELD_DTYPES = {
    "points": POINT_DTYPE, "point_stamps": TIME_DTYPE, "point_weights": POINT_DTYPE,
    "point_ring": torch.int32, "point_tag": torch.int32,
    "imu_stamps": TIME_DTYPE, "imu_gyro": BELIEF_DTYPE, "imu_accel": BELIEF_DTYPE,
    "odom_pose": BELIEF_DTYPE, "odom_cov": BELIEF_DTYPE, "odom_twist": BELIEF_DTYPE,
    "odom_twist_cov": BELIEF_DTYPE, "odom_rel_pose": BELIEF_DTYPE, "odom_rel_cov": BELIEF_DTYPE,
    "cam_Lambdas": BELIEF_DTYPE, "cam_thetas": BELIEF_DTYPE, "cam_etas": BELIEF_DTYPE,
    "cam_weights": BELIEF_DTYPE, "cam_colors": BELIEF_DTYPE, "cam_valid": torch.bool,
    "loop_pose": BELIEF_DTYPE, "loop_cov": BELIEF_DTYPE, "loop_weight": BELIEF_DTYPE,
    "scan_start_time": TIME_DTYPE, "scan_end_time": TIME_DTYPE, "t_scan": TIME_DTYPE,
    "t_last_scan": TIME_DTYPE, "dt_sec": BELIEF_DTYPE, "scan_seq": torch.int32,
}


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def batch_from_numpy(tree, device=None) -> ScanBatch:
    """ScanBatch from a tree of numpy arrays (or tensors) with the ScanBatch
    fields, on `device` (default: the CUDA card)."""
    device = resolve_device(device)

    def conv(x):
        return x if isinstance(x, torch.Tensor) else np.array(x)

    return ScanBatch(**{
        f: torch.as_tensor(conv(_field(tree, f)), dtype=FIELD_DTYPES[f], device=device)
        for f in ScanBatch._fields
    })


def empty_scan_batch(
    n_points: int = C.N_POINTS_CAP,
    n_imu: int = C.MAX_IMU_PREINT_LEN,
    n_feat: int = C.N_FEAT,
    device=None,
) -> ScanBatch:
    """All-zero batch: one zero-weight dummy scan."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def big_eye():
        return 1e12 * torch.eye(6, dtype=BELIEF_DTYPE, device=device)

    return ScanBatch(
        points=z((n_points, 3), POINT_DTYPE),
        point_stamps=z((n_points,), TIME_DTYPE),
        point_weights=z((n_points,), POINT_DTYPE),
        point_ring=z((n_points,), torch.int32),
        point_tag=z((n_points,), torch.int32),
        imu_stamps=z((n_imu,), TIME_DTYPE),
        imu_gyro=z((n_imu, 3), BELIEF_DTYPE),
        imu_accel=z((n_imu, 3), BELIEF_DTYPE),
        odom_pose=z((6,), BELIEF_DTYPE),
        odom_cov=big_eye(),
        odom_twist=z((6,), BELIEF_DTYPE),
        odom_twist_cov=torch.eye(6, dtype=BELIEF_DTYPE, device=device),
        odom_rel_pose=z((6,), BELIEF_DTYPE),
        odom_rel_cov=big_eye(),
        cam_Lambdas=z((n_feat, 3, 3), BELIEF_DTYPE),
        cam_thetas=z((n_feat, 3), BELIEF_DTYPE),
        cam_etas=z((n_feat, C.VMF_N_LOBES, 3), BELIEF_DTYPE),
        cam_weights=z((n_feat,), BELIEF_DTYPE),
        cam_colors=z((n_feat, 3), BELIEF_DTYPE),
        cam_valid=z((n_feat,), torch.bool),
        loop_pose=z((6,), BELIEF_DTYPE),
        loop_cov=big_eye(),
        loop_weight=z((), BELIEF_DTYPE),
        scan_start_time=z((), TIME_DTYPE),
        scan_end_time=z((), TIME_DTYPE),
        t_scan=z((), TIME_DTYPE),
        t_last_scan=z((), TIME_DTYPE),
        dt_sec=z((), BELIEF_DTYPE),
        scan_seq=z((), torch.int32),
    )


def stack_scan_batches(batches: list) -> ScanBatch:
    """Stack a list of ScanBatch into one with a leading time axis."""
    return ScanBatch(*[torch.stack([getattr(b, f) for b in batches]) for f in ScanBatch._fields])


def host_batches(batches: list) -> list:
    """The batches as ScanBatch tuples of numpy arrays on the host, one per
    scan, moved with one device-to-host copy per field (the tools' analyses
    read fields with numpy, which cannot read a CUDA tensor)."""
    if not batches:
        return []
    host = [x.cpu().numpy() for x in stack_scan_batches(batches)]
    return [ScanBatch(*[x[k] for x in host]) for k in range(len(batches))]


def range_weights(dist: np.ndarray) -> np.ndarray:
    """Continuous range-based point weights."""
    a = (dist - C.RANGE_WEIGHT_MIN_R) / C.RANGE_WEIGHT_SIGMA
    b = (C.RANGE_WEIGHT_MAX_R - dist) / C.RANGE_WEIGHT_SIGMA
    w = (1.0 / (1.0 + np.exp(-a))) * (1.0 / (1.0 + np.exp(-b)))
    return w * (1.0 - C.WEIGHT_FLOOR) + C.WEIGHT_FLOOR
