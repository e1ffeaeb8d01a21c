"""Certificate tuples — the audit layer (counterpart of the JAX package's ops/certs.py).

A certificate is a flat NamedTuple of tensors. Fields may carry leading
batch dims (one entry per hypothesis); `aggregate` reduces over the list of
operator certificates only. Approximation triggers are an int64 BITMASK
(36 named bits fit in int64; the JAX package uses uint64, which torch
barely supports — the bit values are identical), never a float.

Building a certificate launches nothing: `make_cert` gives each
Python-number field a view of a device constant made once per (device,
dtype) — the defaults in one row, any other number and `n_triggers` by
value — and the mask an int64 constant of its value. The constants are
shared, so nothing may write into a certificate field in place; they are
made outside a CUDA graph's capture, by the eager first scan (as
scan_step._constant).

Certificates are reduced as one stack (`stack`): the float fields of N
certificates as one (22, N, *batch) tensor in FLOAT_FIELDS order and their
masks as one (N, *batch) int64 tensor, each field broadcast to the stack's
batch, with one op a distinct field shape rather than one a field.
`aggregate`, `finite` and `total_trigger_magnitude` take a stack (or a
list, which they stack), `scrub` stacks its one certificate, and each
reduces by column groups in a handful of ops, whatever N; each result
keeps the shape of the field-by-field rule (a field's broadcast over the
certificates).

Orders. Min, max, the OR of the masks and the finite flag are exact.
`aggregate`'s sums are one torch.sum over the stack's certificate axis, on
which each field's (N, *batch) block lies as the field's own stack of N
would, and its means that sum divided by N. A certificate's trigger
magnitude adds its nine terms left to right, and
`total_trigger_magnitude` folds the magnitudes left to right in list
order, from `start` when it continues a fold.
"""

from __future__ import annotations

import inspect
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Union

import torch

from gcslam_torch.utils.dtypes import BELIEF_DTYPE

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
# aggregate's rule for each float field; the rest are summed
_MIN = ("exact", "eig_min", "dt_scale", "ex_scale", "trust_alpha", "power_beta")
_MAX = ("frobenius_applied", "eig_max", "cond", "anchor_drift_rho")
_MEAN = ("ess_total", "support_frac", "directional_score")


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
    Python numbers become 0-d BELIEF_DTYPE tensors on `device`: read-only
    views of cached constants, so no kernel runs."""
    vals = dict(locals())
    for name, v in vals.items():
        if isinstance(v, torch.Tensor):
            device = v.device
            break
    vals["n_triggers"] = bin(int(triggers)).count("1")
    defaults = _default_fields(device, BELIEF_DTYPE)
    fields = {}
    for f, default in zip(FLOAT_FIELDS, defaults):
        v = vals[f]
        if isinstance(v, torch.Tensor):
            fields[f] = v.to(BELIEF_DTYPE)
        else:
            key = float(v).hex()  # tells -0.0 from 0.0, and matches NaN
            fields[f] = default if key == _DEFAULT_KEYS[f] else _number(key, device, BELIEF_DTYPE)
    return Cert(triggers=_mask(int(triggers), device), **fields)


# make_cert's defaults, n_triggers 0 (no trigger bit)
_DEFAULTS = {f: float(p.default) for f, p in inspect.signature(make_cert).parameters.items() if f in FLOAT_FIELDS}
_DEFAULTS["n_triggers"] = 0.0
_DEFAULT_KEYS = {f: v.hex() for f, v in _DEFAULTS.items()}


@lru_cache(maxsize=None)
def _default_fields(device, dtype) -> tuple:
    """make_cert's default fields on `device`: views of one row made once
    (a copy from the host each certificate would synchronize with the
    card). Read only."""
    return torch.tensor([_DEFAULTS[f] for f in FLOAT_FIELDS], dtype=dtype, device=device).unbind(0)


@lru_cache(maxsize=None)
def _number(key: str, device, dtype) -> torch.Tensor:
    """The 0-d constant float.fromhex(key) on `device`, made once. Read only."""
    return torch.full((), float.fromhex(key), dtype=dtype, device=device)


@lru_cache(maxsize=None)
def _mask(bits: int, device) -> torch.Tensor:
    """The 0-d int64 trigger mask `bits` on `device`, made once. Read only."""
    return torch.full((), bits, dtype=TRIGGER_DTYPE, device=device)


def with_triggers(c: Cert, bits: int) -> Cert:
    """OR extra trigger bits into a certificate's mask."""
    return c._replace(triggers=c.triggers | bits)


class CertStack(NamedTuple):
    """N certificates as one stack: `values` (22, N, *batch) their float
    fields in FLOAT_FIELDS order, `triggers` (N, *batch) their masks, each
    broadcast to its batch; `shapes` a Cert of each field's broadcast shape
    over the N (the shape of its reduction)."""
    values: torch.Tensor
    triggers: torch.Tensor
    shapes: Cert


def _broadcast(x: torch.Tensor, lead: int, shape: torch.Size) -> torch.Tensor:
    """x, its first `lead` dims kept, its others broadcast to `shape`."""
    rest = x.shape[lead:]
    if rest == shape:
        return x
    head = x.shape[:lead]
    return x.reshape(*head, *(1,) * (len(shape) - len(rest)), *rest).expand(*head, *shape)


@lru_cache(maxsize=None)
def _inverse(order: tuple, device) -> torch.Tensor:
    """The inverse of the permutation `order` as an index on `device`, made
    once. Read only."""
    inv = [0] * len(order)
    for p, i in enumerate(order):
        inv[i] = p
    return torch.tensor(inv, dtype=torch.int64, device=device)


def _stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """(len(xs), *shape): the tensors broadcast to their common shape, in
    list order. One stack a distinct shape, then (where there are several)
    one gather back into list order."""
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.shape, []).append(i)
    shape = torch.broadcast_shapes(*groups)
    parts = [_broadcast(torch.stack([xs[i] for i in idx]), 1, shape) for idx in groups.values()]
    if len(parts) == 1:
        return parts[0]
    order = _inverse(tuple(i for idx in groups.values() for i in idx), parts[0].device)
    return torch.cat(parts).index_select(0, order)


def stack(certs: Sequence[Cert]) -> CertStack:
    """Stack certificates for their reductions (module docstring)."""
    if not certs:
        raise ValueError("a certificate stack needs at least one certificate")
    values = _stack([getattr(c, f) for f in FLOAT_FIELDS for c in certs])
    values = values.unflatten(0, (len(FLOAT_FIELDS), len(certs)))
    shapes = Cert(*[torch.broadcast_shapes(*(getattr(c, f).shape for c in certs)) for f in Cert._fields])
    return CertStack(values, _stack([c.triggers for c in certs]), shapes)


def cat(stacks: Sequence[CertStack]) -> CertStack:
    """Stacks joined along the certificate axis, in order."""
    vb = torch.broadcast_shapes(*(s.values.shape[2:] for s in stacks))
    mb = torch.broadcast_shapes(*(s.triggers.shape[1:] for s in stacks))
    return CertStack(torch.cat([_broadcast(s.values, 2, vb) for s in stacks], 1),
                     torch.cat([_broadcast(s.triggers, 1, mb) for s in stacks]),
                     Cert(*[torch.broadcast_shapes(*t) for t in zip(*(s.shapes for s in stacks))]))


def _stacked(certs: Union[Sequence[Cert], CertStack]) -> CertStack:
    return certs if isinstance(certs, CertStack) else stack(certs)


def _fit(x: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """x cut to `shape`, to which it broadcasts (x is constant along the
    dims that `shape` broadcasts)."""
    if x.shape == shape:
        return x
    x = x[(0,) * (x.dim() - len(shape))]
    for d, n in enumerate(shape):
        if n == 1 and x.shape[d] != 1:
            x = x.narrow(d, 0, 1)
    return x


def _unstack(values: torch.Tensor, triggers: torch.Tensor, shapes: Cert) -> Cert:
    """A Cert of the (22, *batch) float fields and the mask, each cut to its
    shape."""
    fields = dict(zip(FLOAT_FIELDS, values.unbind(0)))
    return Cert(*[_fit(triggers if f == "triggers" else fields[f], getattr(shapes, f)) for f in Cert._fields])


@lru_cache(maxsize=None)
def _rules(device, ndim: int) -> tuple:
    """aggregate's column masks (min, max, mean), each (22, 1, ...) with
    `ndim` trailing ones, made once. Read only."""
    return tuple(torch.tensor([f in group for f in FLOAT_FIELDS], device=device).reshape(-1, *(1,) * ndim)
                 for group in (_MIN, _MAX, _MEAN))


@lru_cache(maxsize=None)
def _bit_positions(device) -> torch.Tensor:
    return torch.arange(64, dtype=TRIGGER_DTYPE, device=device)


def _any_bits(masks: torch.Tensor) -> torch.Tensor:
    """The OR of int64 masks (N, *batch) over N: each bit's plane, its max
    over N, the planes put back together (they share no bit, so their sum
    is their OR)."""
    bit = _bit_positions(masks.device)
    return (((masks.unsqueeze(-1) >> bit) & 1).amax(0) << bit).sum(-1)


def aggregate(certs: Union[Sequence[Cert], CertStack]) -> Cert:
    """Aggregate operator certificates (worst-case conditioning, mean
    support, summed mismatch/influence, OR'd triggers) over the list axis;
    per-hypothesis batch dims broadcast."""
    st = _stacked(certs)
    v = st.values
    is_min, is_max, is_mean = _rules(v.device, v.dim() - 2)
    sums = v.sum(1)
    sums = torch.where(is_mean, sums / float(v.shape[1]), sums)
    return _unstack(torch.where(is_min, v.amin(1), torch.where(is_max, v.amax(1), sums)),
                    _any_bits(st.triggers), st.shapes)


def scrub(cert: Cert) -> Cert:
    """Replace non-finite float fields with 0 (triggers pass through)."""
    st = stack([cert])
    return _unstack(torch.nan_to_num(st.values[:, 0], nan=0.0, posinf=0.0, neginf=0.0), cert.triggers, st.shapes)


def finite(certs: Union[Sequence[Cert], CertStack]) -> torch.Tensor:
    """True where no float field of any certificate is NaN."""
    st = _stacked(certs)
    ok = ~torch.isnan(st.values).flatten(0, 1).any(0)
    return _fit(ok, torch.broadcast_shapes(*(getattr(st.shapes, f) for f in FLOAT_FIELDS)))


_MAGNITUDE_FIELDS = ("lift_strength", "psd_projection_delta", "nu_projection_delta", "mass_epsilon_ratio",
                     "anchor_drift_rho", "dt_scale", "ex_scale", "trust_alpha", "power_beta")


def _magnitude(c) -> torch.Tensor:
    return (
        c["lift_strength"]
        + c["psd_projection_delta"]
        + c["nu_projection_delta"]
        + c["mass_epsilon_ratio"]
        + c["anchor_drift_rho"]
        + (1.0 - c["dt_scale"]).abs()
        + (1.0 - c["ex_scale"]).abs()
        + (1.0 - c["trust_alpha"]).abs()
        + (1.0 - c["power_beta"]).abs()
    )


def trigger_magnitude(c: Cert) -> torch.Tensor:
    return _magnitude(c._asdict())


def total_trigger_magnitude(certs: Union[Sequence[Cert], CertStack],
                            start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The certificates' trigger magnitudes folded left to right, from
    `start` (a fold continued) when given: every certificate's at once,
    column-wise, then one add a certificate."""
    st = _stacked(certs)
    mags = _magnitude(dict(zip(FLOAT_FIELDS, st.values.unbind(0)))).unbind(0)
    out = mags[0] if start is None else start + mags[0]
    for m in mags[1:]:
        out = out + m
    shapes = [getattr(st.shapes, f) for f in _MAGNITUDE_FIELDS] + ([] if start is None else [start.shape])
    return _fit(out, torch.broadcast_shapes(*shapes))
