"""Unbalanced Sinkhorn, plain: the port's CUDA kernel replaced by its plain
PyTorch loop (the port's CPU route)."""

from __future__ import annotations

import torch


def _scalars(epsilon: float, tau_a: float, tau_b: float):
    eps = max(float(epsilon), 1e-12)
    return eps, 1.0 / (1.0 + float(tau_a) / eps), 1.0 / (1.0 + float(tau_b) / eps)


def sinkhorn_unbalanced_reference(C, a, b, epsilon, tau_a, tau_b, n_iters: int):
    """Plain PyTorch loop (same iteration and guards as the kernel)."""
    eps, ua, vb = _scalars(epsilon, tau_a, tau_b)
    K_mat = torch.exp(-C / eps)
    u = torch.ones_like(a)
    v = torch.ones_like(b)
    for _ in range(n_iters):
        u = (a / ((K_mat @ v.unsqueeze(-1)).squeeze(-1) + 1e-12)) ** ua
        v = (b / ((K_mat.transpose(-1, -2) @ u.unsqueeze(-1)).squeeze(-1) + 1e-12)) ** vb
    return u[..., :, None] * K_mat * v[..., None, :]


def sinkhorn_unbalanced(C, a, b, epsilon, tau_a, tau_b, n_iters: int):
    return sinkhorn_unbalanced_reference(C, a, b, float(epsilon), float(tau_a), float(tau_b), int(n_iters))
