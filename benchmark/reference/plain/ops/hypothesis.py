"""Hypothesis barycenter projection (counterpart of the JAX package's ops/hypothesis.py):
weight floor -> renormalize -> information barycenter -> PSD projection,
over beliefs stacked on a leading (K,) dim."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.models.belief import Belief
from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.ops.certs import Cert, make_cert, TRIGGERS


class BarycenterOut(NamedTuple):
    belief: Belief
    weights_normalized: torch.Tensor
    floor_adjustment: torch.Tensor
    spread_proxy: torch.Tensor


def hypothesis_barycenter(
    beliefs: Belief,  # fields have a leading (K,) dim
    weights: torch.Tensor,  # (K,)
    weight_floor: float = C.HYP_WEIGHT_FLOOR,
    eps_psd: float = C.EPS_PSD,
    eps_lift: float = C.EPS_LIFT,
) -> Tuple[BarycenterOut, Cert]:
    w_floored = torch.clamp(weights, min=weight_floor)
    floor_adj = (w_floored - weights).abs().sum()
    w = w_floored / w_floored.sum()

    L_out, pc = linalg.domain_projection_psd(torch.einsum("k,kij->ij", w, beliefs.L), eps_psd)
    h_out = torch.einsum("k,ki->i", w, beliefs.h)
    z_lin_out = torch.einsum("k,ki->i", w, beliefs.z_lin)

    mu_k, _ = linalg.spd_solve_lifted(beliefs.L, beliefs.h, eps_lift)
    mean_of_means = torch.einsum("k,ki->i", w, mu_k)
    spread = torch.einsum("k,k->", w, torch.sum((mu_k - mean_of_means) ** 2, dim=-1))

    belief_out = Belief(
        X_anchor=beliefs.X_anchor[0], z_lin=z_lin_out, L=L_out, h=h_out, stamp=beliefs.stamp[0],
    )
    K = w.shape[0]
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["HypothesisProjection"],
        eig_min=pc.eig_min,
        eig_max=pc.eig_max,
        cond=pc.cond,
        near_null_count=pc.near_null_count,
        ess_total=1.0 / torch.sum(w * w),
        support_frac=torch.sum(w > weight_floor).to(w.dtype) / K,
        psd_projection_delta=pc.projection_delta,
        mass_epsilon_ratio=floor_adj / K,
    )
    return BarycenterOut(
        belief=belief_out, weights_normalized=w, floor_adjustment=floor_adj, spread_proxy=spread
    ), cert
