"""Device meshes over torch.distributed (the JAX package's mesh functions,
parallel/sweep.py make_mesh, make_mesh_2d, make_mesh_map) and the rank
launcher.

One process per card with NCCL, or per CPU rank with gloo where the caller
asks for device="cpu". `run_ranks` starts the processes and initialises
the group; inside it, the mesh functions return a `Mesh`: a
`torch.distributed.device_mesh.DeviceMesh` whose dimension names are the
JAX mesh axes, and this rank's coordinate on each.

  - "run": independent replays; each rank keeps a contiguous block of the
    runs and exchanges nothing inside a step;
  - "hyp": the K_HYP axis of the belief stack (make_mesh_2d); each rank
    steps its block of the hypotheses, and the cross-hypothesis reductions
    run, replicated, on the gathered results;
  - "map": the tile axis of the atlas payload (make_mesh_map); each rank
    stores a contiguous block of the tiles, reads at given slots gather
    from the owners, and writes land on the owner alone.

The steps' collectives, and a rank's place on each axis (AxisShard,
ShardContext), are in ops/collectives.py.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from gcslam_torch import constants as C
from gcslam_torch.ops.collectives import AxisShard, ShardContext, register_group

# this process's device where run_ranks started it (gloo ranks may share a card)
_RANK_DEVICE: Optional[torch.device] = None
# seconds the other ranks get to end after one has failed, before they are stopped
_GRACE_S = 10.0


class Mesh:
    """A DeviceMesh over every rank of the default group, with this rank's
    device and its coordinate on each named axis."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        coord = device_mesh.get_coordinate()
        self._shards = {}
        for i, name in enumerate(self.axis_names):
            group = register_group(device_mesh.get_group(name))
            self._shards[name] = AxisShard(name, group, coord[i], device_mesh.shape[i])

    @property
    def shape(self) -> Dict[str, int]:
        return {name: s.size for name, s in self._shards.items()}

    def shard(self, axis: str) -> Optional[AxisShard]:
        """This rank's place on `axis`, None if the mesh has no such axis."""
        return self._shards.get(axis)

    def block(self, axis: str, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's block of n items along `axis` (all n
        without the axis)."""
        s = self._shards.get(axis)
        return (0, n) if s is None else s.block(n)

    def step_context(self) -> ShardContext:
        return ShardContext(hyp=self.shard("hyp"), map=self.shard("map"))


def _new_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group (run the code under run_ranks)")
    world = dist.get_world_size()
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks; the group has {world}")
    if _RANK_DEVICE is None:
        raise RuntimeError("build meshes inside run_ranks, which sets each rank's device")
    return Mesh(init_device_mesh(_RANK_DEVICE.type, shape, mesh_dim_names=names), _RANK_DEVICE)


def make_mesh(n_devices: Optional[int] = None, axis: str = "run") -> Mesh:
    """1-D mesh over all n_devices ranks (default: the world size)."""
    n = dist.get_world_size() if n_devices is None and dist.is_initialized() else n_devices
    return _new_mesh((n,), (axis,))


def make_mesh_2d(n_run: int, n_hyp: int) -> Mesh:
    """2-D mesh ("run", "hyp"): data-parallel replays x model-parallel
    hypotheses. n_hyp must divide K_HYP."""
    if C.K_HYP % n_hyp:
        raise ValueError(f"n_hyp={n_hyp} must divide K_HYP={C.K_HYP}")
    return _new_mesh((n_run, n_hyp), ("run", "hyp"))


def make_mesh_map(n_run: int, n_map: int, atlas_max_tiles: int = C.ATLAS_MAX_TILES) -> Mesh:
    """2-D mesh ("run", "map"): the atlas tile axis shards over "map", so
    the map can outgrow one card. n_map must divide atlas_max_tiles (the
    config's; shard_states checks the atlas it is given as well)."""
    if atlas_max_tiles % n_map:
        raise ValueError(f"n_map={n_map} must divide atlas_max_tiles={atlas_max_tiles}")
    return _new_mesh((n_run, n_map), ("run", "map"))


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world_size: int, device_type: str, backend: str, workdir: str, args) -> None:
    global _RANK_DEVICE
    result_path = os.path.join(workdir, f"result_{rank}.pt")
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # one intra-op thread per CPU rank
            device = torch.device("cpu")
        _RANK_DEVICE = device
        dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "rendezvous"),
                                rank=rank, world_size=world_size)
        try:
            result = fn(device, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, result_path + ".tmp")
        os.replace(result_path + ".tmp", result_path)
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world_size: int, device, *args, timeout: float = 600.0,
              backend: Optional[str] = None) -> list:
    """Run fn(rank_device, *args) in world_size processes (spawned), one
    rank each of a fresh process group: NCCL with one card per rank on
    CUDA, gloo on device="cpu" (one torch thread per rank). With
    backend="gloo" on CUDA the ranks share the cards in turn (rank r on
    card r mod count). fn must be importable (a module-level function) and
    its result picklable; returns the results in rank order.

    Raises if fewer cards than NCCL ranks are visible, if any rank raises
    (with that rank's traceback; the other ranks are stopped _GRACE_S
    seconds later), or if the ranks have not all finished within `timeout`
    seconds."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if (device.type, backend) not in (("cuda", "nccl"), ("cuda", "gloo"), ("cpu", "gloo")):
        raise ValueError(f"no {backend} ranks on {device.type}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is available; pass device='cpu' to run the ranks on the CPU")
        if backend == "nccl" and torch.cuda.device_count() < world_size:
            raise RuntimeError(f"{world_size} ranks need {world_size} cards; {torch.cuda.device_count()} visible")
    ctx = torch.multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="gcslam_ranks_")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, device.type, backend, workdir, args), daemon=True)
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed_at = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + _GRACE_S):
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        errors = []
        for r in range(world_size):
            path = os.path.join(workdir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif procs[r].exitcode not in (0, None) and r not in hung:
                errors.append(f"rank {r}: exit code {procs[r].exitcode}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {world_size} ranks failed:\n" + "\n".join(errors))
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} did not finish within {timeout:.0f} s")
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"), weights_only=False) for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(workdir, ignore_errors=True)
