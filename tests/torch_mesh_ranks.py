"""Rank workers of tests/test_torch_mesh.py and tests/test_torch_mesh_ckpt.py.

run_ranks spawns the ranks, and a spawned process imports the module of
the function it runs: this one imports torch and the port only, so the
ranks never import JAX (the parent test holds the JAX side). Inputs come
from the parent as numpy batch trees, so both packages see the same bytes.
"""

import time

import torch

from gcslam_torch.models.atlas import AtlasState  # noqa: F401 (the field order of rank_atlas)
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import collectives, sinkhorn
from gcslam_torch.parallel import mesh as mesh_mod
from gcslam_torch.parallel import sweep
from gcslam_torch.utils import checkpoint as ckpt

# tests/test_sweep.py's map axis (8 tiles, 64 primitives a tile, 0.5 m voxels)
MAP8 = dict(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
WORLD_SIZE = 4
# family: (world, mesh, config)
FAMILIES = {
    "run": ("no_map8", ("run", 4), dict(with_map=False)),
    "hyp": ("no_map4", ("hyp", 2, 2), dict(with_map=False, hyp_diversify=True)),
    "hyp_1d": ("no_map4", ("run", 4), dict(with_map=False, hyp_diversify=True)),
    "hyp_map": ("map2", ("hyp", 2, 2), dict(MAP8, map_gn_shared=False, hyp_diversify=True)),
    "map": ("map2", ("map", 2, 2), MAP8),
}


def make(spec, cfg: PipelineConfig):
    if spec[0] == "run":
        return mesh_mod.make_mesh(spec[1])
    if spec[0] == "hyp":
        return mesh_mod.make_mesh_2d(spec[1], spec[2])
    return mesh_mod.make_mesh_map(spec[1], spec[2], cfg.atlas_max_tiles)


def to_runs(world, device):
    return [[batch_from_numpy(b, device=device) for b in run] for run in world]


def families(device, worlds: dict) -> dict:
    """Each family's sweep on its mesh: the gathered outputs, the per-scan
    aggregates, the gathered atlas weights, the collectives by axis and the
    (B, N, K) of every Sinkhorn call of this rank."""
    out = {}
    plain = sinkhorn.sinkhorn_unbalanced_reference
    for name, (world, spec, over) in FAMILIES.items():
        cfg = PipelineConfig(**over)
        mesh = make(spec, cfg)
        calls = []

        def recording(*args):
            calls.append(tuple(args[0].shape))
            return plain(*args)

        sinkhorn.sinkhorn_unbalanced_reference = recording
        collectives.COUNTER.clear()
        try:
            states, outs, aggs = sweep.run_sweep(to_runs(worlds[world], device), cfg, mesh=mesh)
        finally:
            sinkhorn.sinkhorn_unbalanced_reference = plain
        per_axis = dict(collectives.COUNTER)
        whole = sweep.gather_states(states, mesh)
        atlas = sweep.gather_atlas(states, mesh)  # this rank's runs, all their tiles
        out[name] = {
            "pose": outs.pose.numpy(),
            "valid_total": outs.tape.map_valid_total.numpy(),
            "pose_mean": torch.stack([a["pose_mean"] for a in aggs]).numpy(),
            "pose_spread": torch.stack([a["pose_spread"] for a in aggs]).numpy(),
            "weights": None if whole.atlas is None else whole.atlas.weights.numpy(),
            "rank_atlas": None if atlas is None else [x.numpy() for x in atlas],
            "run_block": mesh.block("run", len(worlds[world])),
            "hyp_weights": whole.hyp_weights.numpy(),
            "local_shapes": {"beliefs_L": tuple(states.beliefs.L.shape), "hyp_weights": tuple(states.hyp_weights.shape),
                             "atlas_weights": None if states.atlas is None else tuple(states.atlas.weights.shape),
                             "tile_ids": None if states.atlas is None else tuple(states.atlas.tile_ids.shape)},
            "collectives": per_axis,
            "sinkhorn_calls": calls,
        }
    return out


def checkpoints(device, worlds: dict, root: str, n_first: int) -> dict:
    """Save after n_first scans on (run=2, hyp=2) with the map off and on
    (run=2, map=2) with the map on; resume each on its own mesh and on
    (run=4); write the gathered hyp-mesh state to an npz from rank 0."""
    out = {}
    for name, world, spec, over in (("hyp", "no_map4", ("hyp", 2, 2), dict(with_map=False, hyp_diversify=True)),
                                    ("map", "map4", ("map", 2, 2), MAP8)):
        cfg = PipelineConfig(**over)
        runs = to_runs(worlds[world], device)
        first, rest = [r[:n_first] for r in runs], [r[n_first:] for r in runs]
        mesh = make(spec, cfg)
        states, _, _ = sweep.run_sweep(first, cfg, mesh=mesh)
        path = f"{root}/{name}"
        ckpt.save_state_sharded(path, states, mesh)
        _, cont, _ = sweep.run_sweep(rest, cfg, states=states, mesh=mesh)

        like = sweep.shard_states(sweep.batched_init_state(cfg, len(runs), device=device), mesh)
        like_before = [x.clone() for x in ckpt.state_leaves(like)]
        resumed = ckpt.load_state_sharded(path, like, mesh)
        _, res, _ = sweep.run_sweep(rest, cfg, states=resumed, mesh=mesh)

        mesh4 = mesh_mod.make_mesh(4)
        like4 = sweep.shard_states(sweep.batched_init_state(cfg, len(runs), device=device), mesh4)
        resumed4 = ckpt.load_state_sharded(path, like4, mesh4)
        _, res4, _ = sweep.run_sweep(rest, cfg, states=resumed4, mesh=mesh4)

        whole = sweep.gather_states(states, mesh)
        npz = None
        if name == "hyp" and torch.distributed.get_rank() == 0:
            npz = f"{root}/hyp_whole.npz"
            ckpt.save_state(npz, whole)
        out[name] = {
            "saved_local": [x.numpy() for x in ckpt.state_leaves(states)],
            "resumed_local": [x.numpy() for x in ckpt.state_leaves(resumed)],
            "like_untouched": all(torch.equal(a, b) for a, b in zip(like_before, ckpt.state_leaves(like))),
            "whole": [x.numpy() for x in ckpt.state_leaves(whole)],
            "whole_from_run4": [x.numpy() for x in ckpt.state_leaves(sweep.gather_states(resumed4, mesh4))],
            "pose_cont": cont.pose.numpy(),
            "pose_resumed": res.pose.numpy(),
            "pose_resumed_run4": res4.pose.numpy(),
            "npz": npz,
        }
    return out


def hang(device, rank_to_hang: int) -> int:
    """Rank `rank_to_hang` never returns."""
    if torch.distributed.get_rank() == rank_to_hang:
        time.sleep(3600)
    return torch.distributed.get_rank()


def fail(device, rank_to_fail: int) -> int:
    if torch.distributed.get_rank() == rank_to_fail:
        raise ValueError(f"rank {rank_to_fail} fails on purpose")
    return torch.distributed.get_rank()
