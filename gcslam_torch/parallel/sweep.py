"""Replay sweeps on one card: R independent SLAM runs advance together
(counterpart of the JAX package's parallel/sweep.py).

The JAX package scales out by giving independent filter states (bags,
seeds, noise-prior settings) a leading run axis that it shards over a
device mesh. On one card the run axis is `torch.func.vmap` over
`scan_step`: every op of the step takes all R runs at once, so a scan of R
runs costs about one run's kernel launches, and the Sinkhorn takes every
run's problems in one launch (its vmap rule, ops/sinkhorn.py): B = R with
the shared GN chain, B = R * K_HYP per hypothesis.

  - batched_init_state(config, n_runs): n_runs copies of init_state along
    a leading run axis;
  - stack_runs(batches): one scan of each run, stacked along the run axis;
  - sweep_step(states, batches, config): one scan of every run, plus the
    cross-run aggregates `pose_mean` and `pose_spread`;
  - run_sweep(runs, config): the host loop of sweep_step over whole runs.

Entry points run on the CUDA card unless given device="cpu"; sweep_step
runs where its inputs lie. With the map off the state's atlas is None,
which vmap takes as an unbatched argument. The mesh functions of the JAX
package (make_mesh, make_mesh_2d, make_mesh_map, shard_states,
shard_batches) need more than one card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.runner import stack_outputs
from gcslam_torch.models.scan_io import ScanBatch, stack_scan_batches
from gcslam_torch.models.scan_step import StepOutput, StepState, init_state, scan_step
from gcslam_torch.utils.device import resolve_device


def batched_init_state(config: PipelineConfig, n_runs: int, device=None) -> StepState:
    """n_runs independent initial states stacked along a leading run axis,
    on `device` (default: the CUDA card)."""
    config.validate()
    config.check_ported()
    s0 = init_state(config, device=resolve_device(device))

    def rep(x):
        return x.expand((n_runs,) + x.shape).clone()

    return StepState(*[None if sub is None else type(sub)(*map(rep, sub)) if isinstance(sub, tuple) else rep(sub)
                       for sub in s0])


def stack_runs(batches: Sequence[ScanBatch], device=None) -> ScanBatch:
    """One scan of each run stacked along a leading run axis, on `device`
    (default: the CUDA card)."""
    device = resolve_device(device)
    return stack_scan_batches([b.to(device) for b in batches])


def _state_dims(states: StepState) -> StepState:
    """vmap's in/out dims for a state: 0 on every leaf, None for an absent atlas."""
    return StepState(0, 0, 0, 0, None if states.atlas is None else 0, 0)


def sweep_step(states: StepState, batches: ScanBatch, config: PipelineConfig):
    """One scan for EVERY run of the sweep (leading run axis on both
    arguments), plus the cross-run aggregates: the mean pose and the
    largest distance of a run's position from the mean position."""
    dims = _state_dims(states)
    with torch.no_grad():
        states_new, outs = torch.func.vmap(lambda s, b: scan_step(s, b, config),
                                           in_dims=(dims, 0), out_dims=(dims, 0))(states, batches)
        pose_mean = outs.pose.mean(0)
        pose_spread = torch.linalg.vector_norm(outs.pose[:, :3] - pose_mean[None, :3], dim=-1).amax()
    return states_new, outs, {"pose_mean": pose_mean, "pose_spread": pose_spread}


def run_sweep(
    runs: Sequence[Sequence[ScanBatch]],
    config: PipelineConfig,
    states: Optional[StepState] = None,
    device=None,
) -> Tuple[StepState, StepOutput, List[dict]]:
    """Replay R runs of equal length together on `device` (default: the
    CUDA card): returns the final states, the outputs with leading (R, T)
    axes and the per-scan aggregates."""
    device = resolve_device(device)
    n_scans = {len(r) for r in runs}
    if len(n_scans) != 1:
        raise ValueError(f"every run must have the same number of scans, got {sorted(n_scans)}")
    if states is None:
        states = batched_init_state(config, len(runs), device=device)
    outs, aggs = [], []
    for k in range(n_scans.pop()):
        states, out, agg = sweep_step(states, stack_runs([r[k] for r in runs], device=device), config)
        outs.append(out)
        aggs.append(agg)
    stacked = stack_outputs(outs)  # (T, R, ...)
    return states, StepOutput(*[torch.movedim(x, 0, 1) if isinstance(x, torch.Tensor)
                                else type(x)(*[torch.movedim(y, 0, 1) for y in x]) for x in stacked]), aggs
