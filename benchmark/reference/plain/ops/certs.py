"""Certificate tuples — the audit layer (counterpart of the JAX package's ops/certs.py).

A certificate is a flat NamedTuple of tensors. Fields may carry leading
batch dims (one entry per hypothesis); `aggregate` reduces over the list of
operator certificates only. Approximation triggers are an int64 BITMASK
(36 named bits fit in int64; the JAX package uses uint64, which torch
barely supports — the bit values are identical).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from benchmark.reference.plain.utils.dtypes import BELIEF_DTYPE

TRIGGER_NAMES = [
    "MomentToInfo",
    "PointBudgetResample",
    "PredictDiffusion",
    "ImuAccelDirectionTimeResolved",
    "TransportConsistencyWeighting",
    "KappaLowRApproximation",
    "ImuDependenceInflation",
    "ImuGyroRotationGaussian",
    "ImuPreintegrationVelPos",
    "OdomEvidenceGaussian",
    "OdomVelocityEvidence",
    "OdomYawRateEvidence",
    "PoseTwistKinematicConsistency",
    "OdomDependenceInflation",
    "PlanarZPrior",
    "VelocityZPrior",
    "ma_hex3d_binning",
    "plane_fit_batched",
    "wishart_regularization",
    "sinkhorn_fixed_iter",
    "sinkhorn_unbalanced_kl_relax",
    "linearization",
    "ot_soft_correspondence",
    "PowerTempering",
    "ExcitationPriorScaling",
    "InfoFusionAdditive",
    "PoseUpdateFrobeniusRecompose",
    "AnchorDriftUpdate",
    "HypothesisProjection",
    "budgeting",
    "mass_drop",
    "merge_reduce",
    "NonFiniteEvidence",
    "shortlist_pruning",
    "hyp_shared_extraction",
    "approx_selection",
]
TRIGGERS = {name: 1 << i for i, name in enumerate(TRIGGER_NAMES)}
TRIGGER_DTYPE = torch.int64


def decode_triggers(mask: int) -> list[str]:
    return [name for name, bit in TRIGGERS.items() if int(mask) & bit]


class Cert(NamedTuple):
    exact: torch.Tensor
    frobenius_applied: torch.Tensor
    triggers: torch.Tensor  # int64 bitmask
    n_triggers: torch.Tensor
    eig_min: torch.Tensor
    eig_max: torch.Tensor
    cond: torch.Tensor
    near_null_count: torch.Tensor
    ess_total: torch.Tensor
    support_frac: torch.Tensor
    nll_per_ess: torch.Tensor
    directional_score: torch.Tensor
    exc_dt_effect: torch.Tensor
    exc_ex_effect: torch.Tensor
    lift_strength: torch.Tensor
    psd_projection_delta: torch.Tensor
    nu_projection_delta: torch.Tensor
    mass_epsilon_ratio: torch.Tensor
    anchor_drift_rho: torch.Tensor
    dt_scale: torch.Tensor
    ex_scale: torch.Tensor
    trust_alpha: torch.Tensor
    power_beta: torch.Tensor


FLOAT_FIELDS = tuple(f for f in Cert._fields if f != "triggers")


def make_cert(
    exact=True,
    triggers: int = 0,
    frobenius_applied=0.0,
    eig_min=0.0,
    eig_max=0.0,
    cond=1.0,
    near_null_count=0.0,
    ess_total=0.0,
    support_frac=1.0,
    nll_per_ess=0.0,
    directional_score=0.0,
    exc_dt_effect=0.0,
    exc_ex_effect=0.0,
    lift_strength=0.0,
    psd_projection_delta=0.0,
    nu_projection_delta=0.0,
    mass_epsilon_ratio=0.0,
    anchor_drift_rho=0.0,
    dt_scale=1.0,
    ex_scale=1.0,
    trust_alpha=1.0,
    power_beta=1.0,
    device=None,
) -> Cert:
    """Build a certificate; tensor arguments keep their shape (and device),
    Python numbers become 0-d BELIEF_DTYPE tensors on `device`."""
    vals = dict(locals())
    for name, v in vals.items():
        if isinstance(v, torch.Tensor):
            device = v.device
            break

    # torch.full, not torch.tensor: a fill kernel instead of a host-to-device
    # copy, which would synchronize with the stream on a GPU
    def s(x):
        if isinstance(x, torch.Tensor):
            return x.to(BELIEF_DTYPE)
        return torch.full((), float(x), dtype=BELIEF_DTYPE, device=device)

    vals["n_triggers"] = bin(int(triggers)).count("1")
    fields = {f: s(vals[f]) for f in FLOAT_FIELDS}
    return Cert(triggers=torch.full((), int(triggers), dtype=TRIGGER_DTYPE, device=device), **fields)


def with_triggers(c: Cert, bits: int) -> Cert:
    """OR extra trigger bits into a certificate's mask."""
    return c._replace(triggers=c.triggers | bits)


def trigger_magnitude(c: Cert) -> torch.Tensor:
    return (
        c.lift_strength
        + c.psd_projection_delta
        + c.nu_projection_delta
        + c.mass_epsilon_ratio
        + c.anchor_drift_rho
        + (1.0 - c.dt_scale).abs()
        + (1.0 - c.ex_scale).abs()
        + (1.0 - c.trust_alpha).abs()
        + (1.0 - c.power_beta).abs()
    )


def aggregate(certs: Sequence[Cert]) -> Cert:
    """Aggregate operator certificates (worst-case conditioning, mean
    support, summed mismatch/influence, OR'd triggers) over the list axis;
    per-hypothesis batch dims broadcast."""
    if not certs:
        raise ValueError("aggregate needs at least one certificate")

    def stk(f):
        return torch.stack(torch.broadcast_tensors(*[getattr(c, f) for c in certs]))

    mask = stk("triggers")
    out_mask = mask[0]
    for i in range(1, len(certs)):
        out_mask = out_mask | mask[i]
    n = float(len(certs))
    s = {f: stk(f) for f in FLOAT_FIELDS}
    return Cert(
        exact=s["exact"].amin(0),
        frobenius_applied=s["frobenius_applied"].amax(0),
        triggers=out_mask,
        n_triggers=s["n_triggers"].sum(0),
        eig_min=s["eig_min"].amin(0),
        eig_max=s["eig_max"].amax(0),
        cond=s["cond"].amax(0),
        near_null_count=s["near_null_count"].sum(0),
        ess_total=s["ess_total"].sum(0) / n,
        support_frac=s["support_frac"].sum(0) / n,
        nll_per_ess=s["nll_per_ess"].sum(0),
        directional_score=s["directional_score"].sum(0) / n,
        exc_dt_effect=s["exc_dt_effect"].sum(0),
        exc_ex_effect=s["exc_ex_effect"].sum(0),
        lift_strength=s["lift_strength"].sum(0),
        psd_projection_delta=s["psd_projection_delta"].sum(0),
        nu_projection_delta=s["nu_projection_delta"].sum(0),
        mass_epsilon_ratio=s["mass_epsilon_ratio"].sum(0),
        anchor_drift_rho=s["anchor_drift_rho"].amax(0),
        dt_scale=s["dt_scale"].amin(0),
        ex_scale=s["ex_scale"].amin(0),
        trust_alpha=s["trust_alpha"].amin(0),
        power_beta=s["power_beta"].amin(0),
    )


def scrub(cert: Cert) -> Cert:
    """Replace non-finite float fields with 0 (triggers pass through)."""
    return cert._replace(**{
        f: torch.nan_to_num(getattr(cert, f), nan=0.0, posinf=0.0, neginf=0.0)
        for f in FLOAT_FIELDS
    })


def total_trigger_magnitude(certs: Sequence[Cert]) -> torch.Tensor:
    out = trigger_magnitude(certs[0])
    for c in certs[1:]:
        out = out + trigger_magnitude(c)
    return out
