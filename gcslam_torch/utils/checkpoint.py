"""Checkpoint / resume of the filter state (counterpart of the JAX package's
utils/checkpoint.py, npz path).

The file is a flat npz of the StepState's leaves, `leaf_{i}`, in the order
the JAX package's tree flattening gives them: StepState's fields in order,
each NamedTuple field's own fields in order, a None atlas contributing no
leaves. A checkpoint written by either package therefore resumes in the
other.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gcslam_torch.models.scan_step import StepState


def state_leaves(state: StepState) -> List[torch.Tensor]:
    """The state's tensors in the checkpoint's (the JAX tree-flatten) order."""
    out = []
    for sub in state:
        if sub is None:
            continue
        out.extend(sub if isinstance(sub, tuple) else [sub])
    return out


def save_state(path: str, state: StepState) -> None:
    """Write every leaf of `state` to the npz at `path`."""
    arrs = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(state_leaves(state))}
    np.savez_compressed(path, **arrs)


def load_state(path: str, like: StepState) -> StepState:
    """Restore into the structure, dtypes and device of `like` (an
    initialized StepState of the same config); a leaf of another shape
    raises (config mismatch)."""
    restored = []
    with np.load(path) as data:
        for i, ref in enumerate(state_leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected {tuple(ref.shape)} "
                                 "(config mismatch)")
            restored.append(torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype))
    leaves = iter(restored)
    return StepState(*[
        None if sub is None
        else type(sub)(*[next(leaves) for _ in sub]) if isinstance(sub, tuple)
        else next(leaves)
        for sub in like
    ])
