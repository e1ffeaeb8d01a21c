"""Convert a Kimera-style calibration extrinsics.yaml into GC 6D extrinsics.

The reference's tools/kimera_calibration_to_gc.py:1-137. The dataset stores
4x4 homogeneous transforms named T_a_b with the convention p_a = T_a_b @ p_b,
so T_baselink_lidar IS our T_base_lidar; the IMU comes via T_cameralink_gyro
(baselink = cameralink on the Kimera jackal rigs). Emits the GC format
[x, y, z, rx, ry, rz] (translation m + rotation vector rad) and can rewrite
the `frontend: T_base_lidar / T_base_imu` lines of a gcslam config YAML
in place. --imu-rotation overrides the dataset's IMU rotation with a
bag-estimated one (use gcslam_torch.tools.estimate_extrinsics) while keeping
the dataset translation — the dataset's gyro block is often identity-rotated
even when the bag's IMU frame is optical.

Usage:
  python -m gcslam_torch.tools.kimera_calibration_to_gc extrinsics.yaml
  python -m gcslam_torch.tools.kimera_calibration_to_gc extrinsics.yaml \
         --apply --config configs/gc_kimera.yaml \
         [--imu-rotation -1.6027 0.0026 0.0]
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np


def _rotmat_to_rotvec(R: np.ndarray) -> np.ndarray:
    """SO(3) log (no scipy needed at import time; matches ops/se3 semantics)."""
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos))
    if theta < 1e-10:
        return np.zeros(3)
    if abs(np.pi - theta) < 1e-6:  # near pi: use the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diagonal(A), 0.0))
        # fix signs from off-diagonals
        i = int(np.argmax(axis))
        axis = axis * np.sign(A[i] + 1e-30)
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        return theta * axis
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta * w / (2.0 * np.sin(theta))


def _to_6d(T: np.ndarray) -> list:
    T = np.asarray(T, dtype=float)
    if T.shape != (4, 4):
        raise ValueError(f"expected 4x4 transform, got {T.shape}")
    return [*(float(v) for v in T[:3, 3]),
            *(float(v) for v in _rotmat_to_rotvec(T[:3, :3]))]


def _find_transform(data: dict, name: str) -> np.ndarray:
    for t in data.get("transforms", []):
        if t.get("name") == name:
            return np.asarray(t["T"], dtype=float)
    raise KeyError(f"transform {name!r} not found "
                   f"(have: {[t.get('name') for t in data.get('transforms', [])]})")


def convert(extrinsics_yaml: str, imu_rotation=None) -> dict:
    import yaml

    with open(extrinsics_yaml) as f:
        data = yaml.safe_load(f)
    T_base_lidar = _to_6d(_find_transform(data, "T_baselink_lidar"))
    T_cg = _find_transform(data, "T_cameralink_gyro")
    T_base_imu = _to_6d(T_cg)
    if imu_rotation is not None:
        T_base_imu = T_base_imu[:3] + [float(v) for v in imu_rotation]
    out = {"T_base_lidar": [round(v, 6) for v in T_base_lidar],
           "T_base_imu": [round(v, 6) for v in T_base_imu]}
    try:  # camera chain when present: base <- cameralink <- color <- optical
        T = np.eye(4)
        for name in ("T_baselink_cameralink", "T_cameralink_color",
                     "T_color_coloroptical"):
            T = T @ _find_transform(data, name)
        out["T_base_camera"] = [round(v, 6) for v in _to_6d(T)]
    except KeyError:
        pass
    return out


def apply_to_config(config_path: str, ext: dict) -> list:
    """Line-rewrite T_base_* entries inside the config's frontend block;
    returns the list of keys replaced."""
    with open(config_path) as f:
        lines = f.readlines()
    replaced = []
    outl = []
    for line in lines:
        hit = None
        for key in ("T_base_lidar", "T_base_imu", "T_base_camera"):
            if key in ext and re.match(rf"\s*{key}\s*:", line):
                hit = key
                break
        if hit:
            indent = line[:len(line) - len(line.lstrip())]
            vals = ", ".join(f"{v:.6f}" for v in ext[hit])
            outl.append(f"{indent}{hit}: [{vals}]\n")
            replaced.append(hit)
        else:
            outl.append(line)
    with open(config_path, "w") as f:
        f.writelines(outl)
    return replaced


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("extrinsics_yaml")
    p.add_argument("--apply", action="store_true")
    p.add_argument("--config", default="configs/gc_kimera.yaml")
    p.add_argument("--imu-rotation", nargs=3, type=float, default=None,
                   metavar=("RX", "RY", "RZ"))
    args = p.parse_args(argv)

    try:
        ext = convert(args.extrinsics_yaml, args.imu_rotation)
    except (KeyError, ValueError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print("GC extrinsics ([x, y, z, rx, ry, rz] m, rad)")
    for k, v in ext.items():
        print(f"  {k}: {v}")
    if args.apply:
        replaced = apply_to_config(args.config, ext)
        if not replaced:
            print(f"ERROR: no T_base_* lines found in {args.config}",
                  file=sys.stderr)
            return 1
        print(f"updated {args.config}: {', '.join(replaced)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
