"""Replay loop (counterpart of the JAX package's models/runner.py:run_bag): a host
loop over scan_step on one device, returning the final state and the
per-scan outputs stacked along a leading time axis."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import ScanBatch
from gcslam_torch.models.scan_step import ScanTape, StepOutput, StepState, init_state, scan_step


def stack_outputs(outs: List[StepOutput]) -> StepOutput:
    return StepOutput(
        pose=torch.stack([o.pose for o in outs]),
        stamp=torch.stack([o.stamp for o in outs]),
        tape=ScanTape(*[torch.stack([getattr(o.tape, f) for o in outs]) for f in ScanTape._fields]),
    )


def run_bag(
    batches: List[ScanBatch],
    config: PipelineConfig,
    state: Optional[StepState] = None,
    device=None,
) -> Tuple[StepState, StepOutput]:
    """Replay a bag scan by scan on `device` (default: where the batches or
    the given state live)."""
    config.validate()
    config.check_ported()
    if device is None:
        device = state.hyp_weights.device if state is not None else batches[0].points.device
    if state is None:
        state = init_state(config, device=device)
    outs = []
    with torch.no_grad():
        for batch in batches:
            state, out = scan_step(state, batch.to(device), config)
            outs.append(out)
    return state, stack_outputs(outs)
