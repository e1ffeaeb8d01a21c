"""Replay sweeps: R independent SLAM runs advance together, on one card
or over a device mesh (counterpart of the JAX package's parallel/sweep.py).

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
  - sweep_step(states, batches, config, mesh=None): one scan of every
    run, plus the cross-run aggregates `pose_mean` and `pose_spread`;
  - run_sweep(runs, config, mesh=None): the host loop of sweep_step over
    whole runs.

Entry points run on the CUDA card unless given device="cpu"; sweep_step
runs where its inputs lie. With the map off the state's atlas is None,
which vmap takes as an unbatched argument.

Over a device mesh (parallel/mesh.py: make_mesh, make_mesh_2d,
make_mesh_map, each rank one process of run_ranks) a rank holds its block
of the state: shard_states cuts a whole batched state to it, shard_batches
a scan's batches, and gather_states / gather_atlas put the blocks back
together (render_atlas, splat_export and the map stream take a gathered
atlas). The runs split in contiguous blocks over "run" (the JAX P("run"));
the beliefs and hyp_weights split their hypothesis dim over "hyp" (the JAX
P("run", "hyp")); the atlas's (T, M, ...) payload splits its tile dim over
"map" (the JAX P("run", "map")), while the tile table and next_global_id
stay whole on every rank (the JAX package splits the table too;
models/atlas.py says why). sweep_step then vmaps scan_step over the
rank's runs with the mesh's ShardContext, and gathers the poses over "run"
for the aggregates, which it reduces in one fixed order on every rank, so
they equal the unsharded ones. run_sweep returns the whole (R, T, ...)
outputs, gathered, on every rank. With mesh=None not one op changes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from gcslam_torch.models.atlas import TABLE_FIELDS, AtlasState
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.runner import stack_outputs
from gcslam_torch.models.scan_io import ScanBatch, stack_scan_batches
from gcslam_torch.models.scan_step import StepOutput, StepState, init_state, scan_step
from gcslam_torch.ops.collectives import gather_blocks
from gcslam_torch.parallel.mesh import Mesh
from gcslam_torch.utils.checkpoint import shard_dims, state_from_leaves, state_leaves
from gcslam_torch.utils.tree import tree_leaves, tree_rebuild
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


def shard_states(states: StepState, mesh: Mesh) -> StepState:
    """This rank's block of a whole batched state (leading run axis): its
    runs, and on a 2-D mesh its hypotheses or its tiles."""
    leaves = []
    for x, dims in zip(state_leaves(states), shard_dims(states)):
        for axis, d in dims.items():
            lo, hi = mesh.block(axis, x.shape[d])
            x = x.narrow(d, lo, hi - lo)
        leaves.append(x.clone())
    return state_from_leaves(states, leaves)


def shard_batches(batches: ScanBatch, mesh: Mesh) -> ScanBatch:
    """This rank's runs of one scan's stacked batches."""
    lo, hi = mesh.block("run", batches.t_scan.shape[0])
    return ScanBatch(*[x[lo:hi] for x in batches])


def gather_states(states: StepState, mesh: Mesh) -> StepState:
    """The whole batched state, from every rank's block, on every rank."""
    leaves, dims = state_leaves(states), shard_dims(states)
    for axis, dim in (("map", 1), ("hyp", 1), ("run", 0)):  # the dims shard_dims gives each axis
        shard = mesh.shard(axis)
        if shard is None:
            continue
        sel = [i for i, d in enumerate(dims) if axis in d]
        for i, x in zip(sel, gather_blocks([leaves[i] for i in sel], shard, dim)):
            leaves[i] = x
    return state_from_leaves(states, leaves)


def gather_atlas(states: StepState, mesh: Mesh) -> AtlasState:
    """The atlases of this rank's runs with all their tiles (the payload
    gathered over "map"), for render_atlas, splat_export and the map
    stream."""
    atlas = states.atlas
    shard = mesh.shard("map")
    if atlas is None or shard is None:
        return atlas
    payload = [f for f in AtlasState._fields if f not in TABLE_FIELDS]
    whole = dict(zip(payload, gather_blocks([getattr(atlas, f) for f in payload], shard, dim=1)))
    return atlas._replace(**whole)


def sweep_step(states: StepState, batches: ScanBatch, config: PipelineConfig, mesh: Optional[Mesh] = None):
    """One scan for EVERY run of the sweep (leading run axis on both
    arguments), plus the cross-run aggregates: the mean pose and the
    largest distance of a run's position from the mean position. On a
    mesh, states and batches are this rank's blocks, and the aggregates
    are those of all runs."""
    dims = _state_dims(states)
    shard = None if mesh is None else mesh.step_context()
    with torch.no_grad():
        states_new, outs = torch.func.vmap(lambda s, b: scan_step(s, b, config, shard),
                                           in_dims=(dims, 0), out_dims=(dims, 0))(states, batches)
        poses = outs.pose if mesh is None else gather_blocks([outs.pose], mesh.shard("run"))[0]
        pose_mean = poses.mean(0)
        pose_spread = torch.linalg.vector_norm(poses[:, :3] - pose_mean[None, :3], dim=-1).amax()
    return states_new, outs, {"pose_mean": pose_mean, "pose_spread": pose_spread}


def run_sweep(
    runs: Sequence[Sequence[ScanBatch]],
    config: PipelineConfig,
    states: Optional[StepState] = None,
    device=None,
    mesh: Optional[Mesh] = None,
) -> Tuple[StepState, StepOutput, List[dict]]:
    """Replay R runs of equal length together on `device` (default: the
    CUDA card), or over `mesh`, where `runs` holds all R runs, each rank
    replays its block and the device is the rank's: returns the final
    states (on a mesh this rank's block), the outputs with leading (R, T)
    axes (on a mesh gathered from every rank) and the per-scan
    aggregates."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    n_scans = {len(r) for r in runs}
    if len(n_scans) != 1:
        raise ValueError(f"every run must have the same number of scans, got {sorted(n_scans)}")
    if states is None:
        states = batched_init_state(config, len(runs), device=device)
        if mesh is not None:
            states = shard_states(states, mesh)
    if mesh is not None:
        lo, hi = mesh.block("run", len(runs))
        runs = runs[lo:hi]
    outs, aggs = [], []
    for k in range(n_scans.pop()):
        states, out, agg = sweep_step(states, stack_runs([r[k] for r in runs], device=device), config, mesh)
        outs.append(out)
        aggs.append(agg)
    stacked = stack_outputs(outs)  # (T, R, ...)
    if mesh is not None:
        stacked = tree_rebuild(stacked, gather_blocks(tree_leaves(stacked), mesh.shard("run"), dim=1))
    return states, StepOutput(*[torch.movedim(x, 0, 1) if isinstance(x, torch.Tensor)
                                else type(x)(*[torch.movedim(y, 0, 1) for y in x]) for x in stacked]), aggs
