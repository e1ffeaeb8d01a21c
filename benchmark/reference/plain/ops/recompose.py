"""Pose recompose (Frobenius-blended BCH3 chart shift) + continuous anchor
drift (counterpart of the JAX package's ops/recompose.py). Batched over leading dims.

  - recompose: s = mag / (mag + c_frob); delta' = delta + s * 1/2 [z_lin_pose, delta];
    X_new = X_anchor o Exp(delta'); z' = z - shift, h' = h - L shift.
  - anchor drift: rho = clip(max(|dt|/M0, |dr|/R0), 0, 1); the anchor absorbs
    rho of the increment; z_lin' = (1 - rho) dz; h' = L z_lin'.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.models.belief import Belief, mean_increment
from benchmark.reference.plain.ops import se3
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS
from benchmark.reference.plain.ops.se3 import mv


def bch3_correction(xi1: torch.Tensor, xi2: torch.Tensor) -> torch.Tensor:
    """0.5 [xi1, xi2] for se(3) twists in [trans, rot] ordering."""
    v1, w1 = xi1[..., :3], xi1[..., 3:6]
    v2, w2 = xi2[..., :3], xi2[..., 3:6]
    cross = torch.linalg.cross
    return 0.5 * torch.cat([cross(w1, v2) + cross(v1, w2), cross(w1, w2)], dim=-1)


class RecomposeOut(NamedTuple):
    belief: Belief
    delta_pose: torch.Tensor
    frobenius_strength: torch.Tensor


def pose_update_frobenius_recompose(
    belief_post: Belief,
    total_trigger_magnitude: torch.Tensor,
    c_frob: float = C.C_FROB,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[RecomposeOut, Cert]:
    delta_pose = mean_increment(belief_post, eps_lift)[..., C.IDX_POSE]
    strength = total_trigger_magnitude / (total_trigger_magnitude + c_frob)
    correction = bch3_correction(belief_post.z_lin[..., C.IDX_POSE], delta_pose)
    delta_corrected = delta_pose + strength[..., None] * correction

    X_new = se3.se3_compose(belief_post.X_anchor, se3.se3_exp(delta_corrected))
    shift = torch.cat([delta_corrected, torch.zeros_like(belief_post.z_lin[..., 6:])], dim=-1)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["PoseUpdateFrobeniusRecompose"],
        frobenius_applied=(strength > torch.finfo(strength.dtype).eps).to(strength.dtype),
    )
    belief_new = Belief(
        X_anchor=X_new,
        z_lin=belief_post.z_lin - shift,
        L=belief_post.L,
        h=belief_post.h - mv(belief_post.L, shift),
        stamp=belief_post.stamp,
    )
    return RecomposeOut(belief=belief_new, delta_pose=delta_corrected, frobenius_strength=strength), cert


class AnchorDriftOut(NamedTuple):
    belief: Belief
    rho: torch.Tensor
    drift_m: torch.Tensor
    drift_r: torch.Tensor


def anchor_drift_update(
    b: Belief,
    M0: float = C.ANCHOR_DRIFT_M0,
    R0: float = C.ANCHOR_DRIFT_R0,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[AnchorDriftOut, Cert]:
    delta_z = mean_increment(b, eps_lift)
    delta_pose = delta_z[..., C.IDX_POSE]
    drift_m = torch.linalg.vector_norm(delta_pose[..., :3], dim=-1)
    drift_r = torch.linalg.vector_norm(delta_pose[..., 3:6], dim=-1)
    rho = torch.clamp(torch.maximum(drift_m / M0, drift_r / R0), 0.0, 1.0)

    X_new = se3.se3_compose(b.X_anchor, se3.se3_exp(rho[..., None] * delta_pose))
    z_lin_new = (1.0 - rho[..., None]) * delta_z
    cert = make_cert(exact=False, triggers=TRIGGERS["AnchorDriftUpdate"], anchor_drift_rho=rho)
    out = AnchorDriftOut(
        belief=Belief(X_anchor=X_new, z_lin=z_lin_new, L=b.L, h=mv(b.L, z_lin_new), stamp=b.stamp),
        rho=rho,
        drift_m=drift_m,
        drift_r=drift_r,
    )
    return out, cert
