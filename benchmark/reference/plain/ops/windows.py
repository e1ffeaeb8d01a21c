"""Soft time-membership windows (counterpart of the JAX package's ops/windows.py).

w(t) = sigmoid((t - start)/sigma) * sigmoid((end - t)/sigma), floored to a
strictly positive continuous weight. `sigma` may carry leading batch dims
(one window per hypothesis); the result is then (..., len(stamps)).
"""

from __future__ import annotations

import torch

from benchmark.reference.plain import constants as C
from benchmark.reference.plain.utils.dtypes import BELIEF_DTYPE


def smooth_window_weights(
    stamps: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    sigma: torch.Tensor,
) -> torch.Tensor:
    if isinstance(sigma, torch.Tensor):  # no torch.as_tensor on the step's path
        sig = sigma.to(device=stamps.device, dtype=stamps.dtype)
    else:
        sig = torch.as_tensor(sigma, dtype=stamps.dtype, device=stamps.device)
    sig = torch.clamp(sig, min=1e-6)
    sig = sig.unsqueeze(-1)
    a = (stamps - start) / sig
    b = (end - stamps) / sig
    w_raw = torch.sigmoid(a) * torch.sigmoid(b)
    wf = C.WEIGHT_FLOOR
    return (w_raw * (1.0 - wf) + wf).to(BELIEF_DTYPE)
