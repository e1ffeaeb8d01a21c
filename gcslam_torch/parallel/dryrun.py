"""Multi-device dry run of the replay sweep (counterpart of the JAX
package's __graft_entry__.dryrun_multichip).

    python3 -m gcslam_torch.parallel.dryrun --devices N [--cpu]

Replays one tiny world (5 scans of 256 points, the map on at 8 tiles of
64 primitives) in every run of two mesh families, one rank per card
(NCCL), or N gloo ranks on the CPU with --cpu:
  - ("run", "hyp") with n_hyp = 4 or 2 where it divides both N and K_HYP,
    else the 1-D ("run",) mesh over all N;
  - ("run", "map") with n_map = 4 or 2 where it divides N and the 8 tiles.
Every run is the same replay, so every run's pose at every scan must
equal the single-device reference (run_sweep of the one run, no mesh) to
1e-8. Asking for more cards than are visible raises.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np

TINY = dict(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
N_SCANS = 5
N_POINTS = 256
TOL = 1e-8


def families(n_devices: int) -> List[Tuple[str, int, int]]:
    """(family, n_run, n of the second axis) of the dry run on n_devices."""
    from gcslam_torch import constants as C

    n_hyp = next((c for c in (4, 2) if n_devices % c == 0 and C.K_HYP % c == 0), 1)
    out = [("run_hyp", n_devices // n_hyp, n_hyp) if n_hyp > 1 else ("run", n_devices, 1)]
    n_map = next((c for c in (4, 2) if n_devices % c == 0 and TINY["atlas_max_tiles"] % c == 0), 1)
    if n_map > 1:
        out.append(("run_map", n_devices // n_map, n_map))
    return out


def _world(device):
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate

    return generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS), device=device).batches


def _rank(device, n_devices: int) -> dict:
    """One rank: each family's poses (R, N_SCANS, 6), gathered."""
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.parallel import mesh as mesh_mod
    from gcslam_torch.parallel import sweep

    cfg = PipelineConfig(**TINY)
    run = _world(device)
    out = {}
    for name, n_run, n_sub in families(n_devices):
        if name == "run_hyp":
            mesh = mesh_mod.make_mesh_2d(n_run, n_sub)
        elif name == "run_map":
            mesh = mesh_mod.make_mesh_map(n_run, n_sub, cfg.atlas_max_tiles)
        else:
            mesh = mesh_mod.make_mesh(n_devices)
        _, outs, _ = sweep.run_sweep([run] * n_run, cfg, mesh=mesh)
        out[name] = outs.pose.cpu().numpy()
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the families on n_devices ranks (cards, or gloo ranks with
    device="cpu") and hold every run to the single-device reference;
    returns {family: {"mesh", "runs", "max_abs_err"}}."""
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.parallel import mesh as mesh_mod
    from gcslam_torch.parallel import sweep
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device(device)
    _, ref, _ = sweep.run_sweep([_world(device)], PipelineConfig(**TINY), device=device)
    ref = ref.pose.cpu().numpy()  # (1, N_SCANS, 6)
    if not np.all(np.isfinite(ref)):
        raise AssertionError("single-device reference non-finite")
    results = mesh_mod.run_ranks(_rank, n_devices, device, n_devices)
    report = {}
    for name, n_run, n_sub in families(n_devices):
        poses = results[0][name]
        if poses.shape != (n_run, N_SCANS, 6) or not np.all(np.isfinite(poses)):
            raise AssertionError(f"dryrun {name}: poses of shape {poses.shape}, or non-finite")
        err = float(np.abs(poses - ref).max())
        if not err < TOL:
            raise AssertionError(f"dryrun {name}: trajectory mismatch vs single-device: {err:.3e}")
        for r in range(1, n_devices):
            if not np.array_equal(results[r][name], poses):
                raise AssertionError(f"dryrun {name}: rank {r}'s gathered poses differ from rank 0's")
        axes = ("run",) if name == "run" else ("run", name.split("_")[1])
        shape = dict(zip(axes, (n_run, n_sub)[:len(axes)]))
        report[name] = {"mesh": shape, "runs": n_run, "max_abs_err": err}
        print(f"dryrun ({', '.join(axes)}) OK: mesh {shape} on {n_devices} {device.type} ranks, {N_SCANS} scans, "
              f"max|pose - single_device| = {err:.2e}", flush=True)
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python3 -m gcslam_torch.parallel.dryrun")
    p.add_argument("--devices", type=int, required=True, help="ranks: one card each (NCCL), or gloo ranks with --cpu")
    p.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (default: one CUDA card per rank)")
    args = p.parse_args(argv)
    report = dryrun_multichip(args.devices, "cpu" if args.cpu else None)
    print(json.dumps({"dryrun": report}))
    return report


if __name__ == "__main__":
    main()
