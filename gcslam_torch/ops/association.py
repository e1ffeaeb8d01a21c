"""Primitive association via unbalanced Sinkhorn OT over the stencil pool
(counterpart of the JAX package's ops/association.py).

  - candidates: per measurement, either the k_shortlist nearest valid pool
    rows within the stencil reach (+ margin), selected once per scan, or,
    with k_shortlist = 0, the whole pool (an (N, P) cost tile);
  - cost C[i,k] = ||x_i - x_k||^2 + beta * (1 - Bhattacharyya of the vMF
    lobes) + recency bias; masked candidates cost 1e12; optionally the
    row minimum is subtracted (ot_subtract_row_min);
  - exact top-k_assoc by cost (ties to the lowest index, like lax.top_k);
  - fixed-iteration unbalanced Sinkhorn (ops/sinkhorn: the CUDA kernel on
    the card); responsibilities = pi (no row normalization).

Measurement batches, poses and shortlists may carry a leading hypothesis
dim; the view is shared.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gcslam_torch.models.batch import MeasurementBatch, kappas, mean_directions, mean_positions
from gcslam_torch.ops import se3
from gcslam_torch.ops.certs import Cert, TRIGGERS, make_cert
from gcslam_torch.ops.sinkhorn import sinkhorn_unbalanced
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, POINT_DTYPE

_LOG_2 = math.log(2.0)
_LOG_4PI = math.log(4.0 * math.pi)


class AssociationResult(NamedTuple):
    responsibilities: torch.Tensor  # (N, K)
    cand_pool: torch.Tensor  # (N, K) pool rows
    cand_sl: torch.Tensor  # (N, K) rows into the shortlist
    row_masses: torch.Tensor  # (N,)
    cost: torch.Tensor  # (N, K)
    transport_mass: torch.Tensor
    marginal_defect_a: torch.Tensor
    ess_ot: torch.Tensor


class CandidateSet(NamedTuple):
    """Pose-invariant candidate attributes, gathered once per scan."""

    idx: torch.Tensor  # (N, Ks) pool rows
    pos: torch.Tensor  # (N, Ks, 3)
    dirs: torch.Tensor  # (N, Ks, 3)
    weights: torch.Tensor  # (N, Ks)
    kap: torch.Tensor  # (N, Ks) POINT_DTYPE
    eta: torch.Tensor  # (N, Ks, 3) POINT_DTYPE
    eta_sq: torch.Tensor  # (N, Ks)
    A_k2: torch.Tensor  # (N, Ks)
    last_supported: torch.Tensor  # (N, Ks)
    valid: torch.Tensor  # (N, Ks) bool
    lidar_frac: Optional[torch.Tensor] = None  # (N, Ks)


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, largest first, ties to the lowest index
    (the lax.top_k order; torch.topk promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _log_A_vmf(k: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """A(k) = log(4 pi) + log(sinh k) - log k, numerically stable."""
    k = torch.clamp(k, min=eps)
    log_sinh = torch.where(
        k > 20.0,
        k - _LOG_2,
        torch.where(k >= 1e-2, torch.log(torch.sinh(k)), torch.log(k + k**3 / 6.0)),
    )
    return _LOG_4PI + log_sinh - torch.log(k)


def gather_candidates(view, idx: torch.Tensor) -> CandidateSet:
    """One-shot (N, Ks) gather of every round-invariant candidate attribute."""
    ckap = view.kappas[idx].to(POINT_DTYPE)
    ceta = (view.kappas[:, None] * view.directions)[idx].to(POINT_DTYPE)
    return CandidateSet(
        idx=idx,
        pos=view.positions[idx],
        dirs=view.directions[idx],
        weights=view.weights[idx],
        kap=ckap,
        eta=ceta,
        eta_sq=torch.sum(ceta**2, dim=-1),
        A_k2=_log_A_vmf(torch.clamp(ckap, min=1e-12)),
        last_supported=view.last_supported[idx],
        valid=view.valid[idx],
        lidar_frac=None if view.lidar_frac is None else view.lidar_frac[idx],
    )


def shortlist_candidates(meas_pos_world: torch.Tensor, meas_valid: torch.Tensor, view, cfg) -> torch.Tensor:
    """(N, k_shortlist) pool rows nearest each measurement (world frame)
    within the stencil reach + shortlist_margin_m; invalid rows rank last."""
    mp = meas_pos_world.to(POINT_DTYPE)
    vp = view.positions.to(POINT_DTYPE)
    d = (mp * mp).sum(1)[:, None] - 2.0 * mp @ vp.T + (vp * vp).sum(1)[None, :]
    reach = 2.0 * cfg.h_tile * (cfg.r_stencil_xy + 0.5) + cfg.shortlist_margin_m
    ok = view.valid[None, :] & meas_valid[:, None] & (d < reach * reach)
    d = torch.where(ok, d, torch.inf)
    _, idx = topk_lowest_index(-d, min(cfg.k_shortlist, d.shape[-1]))
    return idx




def _vmf_cost(meas_eta, meas_kap, d_pos, ceta_sq, cross, A_k2, ckap, cfg):
    """Squared distance d_pos + ot_cost_beta * (1 - Bhattacharyya of the vMF
    lobes), in POINT_DTYPE; `cross` = meas_eta . cand_eta per pair, the
    candidate terms broadcast against (..., N, C)."""
    km = 0.5 * torch.sqrt(torch.clamp(torch.sum(meas_eta**2, dim=-1)[..., None] + ceta_sq + 2.0 * cross, min=1e-24))
    A_k1 = _log_A_vmf(torch.clamp(meas_kap.to(POINT_DTYPE), min=1e-12))[..., None]
    bc = torch.exp(_log_A_vmf(km) - 0.5 * (A_k1 + A_k2))
    d_dir = torch.clamp(1.0 - bc, min=0.0)
    dir_on = ((meas_kap[..., None] > 0) & (ckap > 0)).to(POINT_DTYPE)
    return d_pos + cfg.ot_cost_beta * d_dir * dir_on


def associate_primitives_ot(
    batch: MeasurementBatch,
    view,
    scan_seq: torch.Tensor,
    cfg,
    z_lin_pose: torch.Tensor,  # (..., 6) world pose
    shortlist: Optional[CandidateSet],
    ot_epsilon: float,
) -> Tuple[AssociationResult, Cert]:
    """OT association of the measurement batch (body frame at z_lin_pose)
    against its shortlisted candidates, or against the whole view when
    `shortlist` is None (k_shortlist = 0); `ot_epsilon` is this GN round's
    annealed kernel width. The batch, the pose and the shortlist may carry
    one leading hypothesis dim (the view is shared): all hypotheses' plans
    then come from ONE Sinkhorn call on C (K_HYP, N, k_assoc)."""
    f = BELIEF_DTYPE
    p32 = POINT_DTYPE
    N = batch.valid.shape[-1]
    K = cfg.k_assoc

    R0T = se3.so3_exp(z_lin_pose[..., 3:6]).transpose(-1, -2)
    meas_pos = mean_positions(batch, cfg.eps_lift) @ R0T + z_lin_pose[..., None, :3]
    meas_dir = mean_directions(batch, cfg.eps_mass) @ R0T
    meas_kap = kappas(batch)
    valid_f = batch.valid.to(f)

    mp = meas_pos.to(p32)
    meas_eta = (meas_kap[..., None] * meas_dir).to(p32)
    reach_sq = (2.0 * cfg.h_tile * (cfg.r_stencil_xy + 0.5)) ** 2
    recency_w = ot_epsilon * cfg.recency_decay_lambda
    seq = scan_seq.to(torch.int32)

    if shortlist is None:
        # full-pool (N, P) cost over the whole view
        vp = view.positions.to(p32)
        d_pos = torch.sum(mp * mp, dim=-1)[..., None] - 2.0 * mp @ vp.T + torch.sum(vp * vp, dim=1)
        view_eta = (view.kappas[:, None] * view.directions).to(p32)
        vkap = view.kappas.to(p32)
        cost = _vmf_cost(meas_eta, meas_kap, d_pos, torch.sum(view_eta**2, dim=1), meas_eta @ view_eta.T,
                         _log_A_vmf(torch.clamp(vkap, min=1e-12)), view.kappas, cfg)
        # recency bias in f64 (the reference promotes here: its annealed
        # epsilon is an f64 array)
        cost = cost.to(f) + recency_w * torch.clamp(seq - view.last_supported, min=0).to(f)
        ok = view.valid & batch.valid[..., None] & (d_pos < reach_sq)
        neg_top, cand = topk_lowest_index(-torch.where(ok, cost, 1e12), K)
        cand_sl = cand
    else:
        cs = shortlist
        diff = mp[..., None, :] - cs.pos.to(p32)
        d_pos = torch.sum(diff * diff, dim=-1)  # (..., N, Ks)
        cost = _vmf_cost(meas_eta, meas_kap, d_pos, cs.eta_sq, torch.einsum("...ni,...nki->...nk", meas_eta, cs.eta),
                         cs.A_k2, cs.kap, cfg)
        cost = cost.to(f) + recency_w * torch.clamp(seq - cs.last_supported, min=0).to(f)
        ok = cs.valid & batch.valid[..., None] & (d_pos < reach_sq)
        neg_top, cand_sl = topk_lowest_index(-torch.where(ok, cost, 1e12), K)
        cand = torch.gather(cs.idx, -1, cand_sl)
    cost = -neg_top
    cand_valid = torch.gather(ok, -1, cand_sl)

    if cfg.ot_subtract_row_min:
        # reference cost normalization; masked candidates are re-masked
        # afterwards so the subtraction never zeroes one
        row_min = torch.amin(torch.where(cand_valid, cost, torch.inf), dim=-1, keepdim=True)
        cost = cost - torch.where(torch.isfinite(row_min), row_min, 0.0)
    cost_n = torch.where(cand_valid, cost, 1e12)

    a = valid_f / torch.clamp(valid_f.sum(-1, keepdim=True), min=cfg.eps_mass)
    b = torch.full(a.shape[:-1] + (K,), 1.0 / K, dtype=f, device=a.device)
    pi = sinkhorn_unbalanced(cost_n, a, b, ot_epsilon, cfg.ot_tau_a, cfg.ot_tau_b, cfg.k_sinkhorn)
    pi = pi * cand_valid.to(f)
    row_masses = pi.sum(-1)
    transport_mass = pi.sum((-2, -1))
    result = AssociationResult(
        responsibilities=pi,
        cand_pool=cand,
        cand_sl=cand_sl,
        row_masses=row_masses,
        cost=cost_n,
        transport_mass=transport_mass,
        marginal_defect_a=torch.linalg.vector_norm(row_masses - a, dim=-1),
        ess_ot=row_masses.sum(-1) ** 2 / (torch.sum(row_masses**2, dim=-1) + cfg.eps_mass),
    )
    triggers = TRIGGERS["sinkhorn_fixed_iter"] | TRIGGERS["sinkhorn_unbalanced_kl_relax"]
    if shortlist is not None:
        triggers |= TRIGGERS["shortlist_pruning"]
    cert = make_cert(
        exact=False,
        triggers=triggers,
        ess_total=result.ess_ot,
        support_frac=valid_f.sum(-1) / N,
        mass_epsilon_ratio=cfg.eps_mass / (transport_mass + cfg.eps_mass),
    )
    return result, cert
