"""Where the port's entry points run: the CUDA card unless the caller names
another device. There is no silent fallback to the CPU — asking for the
card where there is none raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None; raises when the device is
    CUDA and no card is available (pass device="cpu" to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' to run on the CPU")
    return dev
