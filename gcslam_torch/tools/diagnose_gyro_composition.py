"""Gyro-evidence composition-side diagnostic: does the evidence push the
state in the SAME direction as the measured rotation increment?

The reference's tools/diagnose_gyro_composition.py:1-182 probes the classic
left/right composition mismatch (R @ exp(delta) vs exp(delta) @ R, or a
flipped residual sign): feed a known gyro delta into the gyro rotation
evidence and check that the zero-prior posterior increment
L_rot^{-1} h_rot has the same sign as the delta. We probe at identity AND
at non-trivial start rotations — the mismatch only shows away from
identity, where the two composition sides genuinely differ.

Also probes the odometry relative-pose factor the same way (our extension:
the same class of bug bites any relative factor).

The evidence operators run in float64 on the CUDA card (on the CPU with
--cpu); the posterior solve is host numpy. The odometry probe's failure is
reported in its entry only when it is a TypeError (what a signature change
raises); any other error, a device fault among them, propagates.

Usage:
  python -m gcslam_torch.tools.diagnose_gyro_composition [--json] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _np(x) -> np.ndarray:
    return x.cpu().numpy().astype(float)


def _probe_gyro(rotvec_start, delta_rotvec, dt_int=0.1, device=None):
    import torch

    from gcslam_torch import constants as C
    from gcslam_torch.ops import se3
    from gcslam_torch.ops.evidence_imu import imu_gyro_rotation_evidence

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    rotvec_start = t(rotvec_start)
    delta = t(delta_rotvec)
    # prediction did not move: end_pred = start, so the whole delta is the
    # residual the evidence must reproduce
    L, h, r_rot, cert = imu_gyro_rotation_evidence(
        rotvec_start_WB=rotvec_start,
        rotvec_end_pred_WB=rotvec_start,
        delta_rotvec_meas=delta,
        Sigma_g=1e-3 * t(np.eye(3)),
        dt_int=t(dt_int),
    )
    L_rot = _np(L[C.IDX_ROT, C.IDX_ROT])
    h_rot = _np(h[C.IDX_ROT])
    post = np.linalg.solve(L_rot + 1e-12 * np.eye(3), h_rot)

    # ground truth: the increment that takes R_pred to R_start@exp(delta),
    # expressed in the prediction's tangent (right perturbation)
    R_start = _np(se3.so3_exp(rotvec_start))
    R_end = _np(se3.so3_exp(rotvec_start)) @ _np(se3.so3_exp(delta))
    expected = _np(se3.so3_log(t(R_start.T @ R_end)))
    same_sign = bool(np.dot(post, expected) > 0)
    return {
        "rotvec_start_deg": [round(float(np.degrees(v)), 2) for v in _np(rotvec_start)],
        "delta_deg": [round(float(np.degrees(v)), 2) for v in _np(delta)],
        "posterior_increment_deg": [round(float(np.degrees(v)), 3) for v in post],
        "expected_increment_deg": [round(float(np.degrees(v)), 3) for v in expected],
        "residual_matches_delta": bool(np.linalg.norm(_np(r_rot) - expected) < 1e-6),
        "same_direction": same_sign,
        "increment_error_deg": round(float(np.degrees(np.linalg.norm(post - expected))), 4),
    }


def _probe_odom_relative(device=None):
    """Same test on the relative odometry factor: previous pose known, odom
    says 'moved +x and +10 deg yaw' — does the factor pull the current pose
    there?"""
    import torch

    from gcslam_torch import constants as C
    from gcslam_torch.ops import se3
    from gcslam_torch.ops.evidence_odom import odom_quadratic_evidence

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    prev = t([1.0, 2.0, 0.0, 0.0, 0.0, np.deg2rad(30.0)])
    delta = t([0.5, 0.0, 0.0, 0.0, 0.0, np.deg2rad(10.0)])
    target = se3.se3_compose(prev, se3.se3_exp(delta))
    # predicted current pose = previous (no motion applied): full pull = delta
    pred = prev
    L, h, cert = odom_quadratic_evidence(
        pose_pred=pred,
        odom_pose=target,
        odom_cov=1e-4 * t(np.eye(6)),
    )
    Lp = _np(L[C.IDX_POSE, C.IDX_POSE])
    hp = _np(h[C.IDX_POSE])
    post = np.linalg.solve(Lp + 1e-9 * np.eye(6), hp)
    expected = _np(se3.se3_log(se3.se3_relative(target, pred)))
    return {
        "posterior_increment": [round(float(v), 4) for v in post],
        "expected_increment": [round(float(v), 4) for v in expected],
        "same_direction": bool(np.dot(post, expected) > 0),
        "increment_error": round(float(np.linalg.norm(post - expected)), 5),
    }


def diagnose_gyro_composition(device=None) -> dict:
    """The probes on `device` (default: the CUDA card)."""
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device(device)
    probes = [
        _probe_gyro([0.0, 0.0, 0.0], [0.0, 0.0, np.deg2rad(10)], device=device),
        _probe_gyro([0.0, 0.0, np.deg2rad(90)], [0.0, 0.0, np.deg2rad(10)], device=device),
        _probe_gyro([np.deg2rad(20), 0.0, np.deg2rad(45)],
                    [np.deg2rad(-5), np.deg2rad(3), np.deg2rad(10)], device=device),
    ]
    ok = all(p["same_direction"] and p["increment_error_deg"] < 0.5
             for p in probes)
    try:
        odom = _probe_odom_relative(device)
        odom_ok = odom["same_direction"] and odom["increment_error"] < 1e-2
    except TypeError as e:  # signature drift must not kill the gyro verdict
        odom, odom_ok = {"error": str(e)[:200]}, None
    return {
        "gyro_probes": probes,
        "odom_relative_probe": odom,
        "verdict": ("OK" if ok and odom_ok is not False
                    else "COMPOSITION_MISMATCH"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    info = diagnose_gyro_composition("cpu" if args.cpu else None)
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        for i, pr in enumerate(info["gyro_probes"]):
            print(f"gyro probe {i}: start={pr['rotvec_start_deg']} deg  "
                  f"delta={pr['delta_deg']} deg")
            print(f"  posterior increment {pr['posterior_increment_deg']} deg  "
                  f"(expected {pr['expected_increment_deg']}; "
                  f"err {pr['increment_error_deg']} deg)  "
                  f"{'ok' if pr['same_direction'] else 'OPPOSITE DIRECTION'}")
        od = info["odom_relative_probe"]
        if "error" not in od:
            print(f"odom relative probe: err {od['increment_error']}  "
                  f"{'ok' if od['same_direction'] else 'OPPOSITE DIRECTION'}")
        print(f"verdict: {info['verdict']}")
    return 0 if info["verdict"] == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
