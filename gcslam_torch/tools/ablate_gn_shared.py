"""map_gn_shared ablation at production budgets (counterpart of the JAX
package's tools/ablate_gn_shared.py): the shared GN chain (one alignment
chain per scan from hypothesis 0's predicted pose, the default) against a
GN chain per hypothesis, with the shared surfel extraction and without it
(the reference's per-hypothesis semantics), on the HARD regime — the
circuit trajectory with dead-reckoned (integrated-drift) odometry at 0.05
m/m and 0.02 rad/m, where the map must supply the correction authority.

  python -m gcslam_torch.tools.ablate_gn_shared [--scans 80] [--cpu] [--json PATH]

Per mode: ATE, ms/scan of a timed run_bag after a 5-scan warm-up
(host clock, ending in torch.cuda.synchronize()), the warm-up's seconds
(the kernels' one-time build included) and the Sinkhorn launches of the
timed run (on the card; every per-hypothesis launch takes all K_HYP
problems). The belief runs in float32, as the JAX tool's: the process runs
itself anew with GCSLAM_BELIEF_DTYPE=float32 where the dtype differs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

MODES = {
    "shared": {},  # the default: map_gn_shared=True
    "per_hyp_gn": {"map_gn_shared": False},
    "no_share": {"map_gn_shared": False, "map_share_extraction": False},
}
REGIME = dict(trajectory="circuit", odom_model="integrated", odom_drift_pos_per_m=0.05, odom_drift_yaw_per_m=0.02)
N_WARMUP = 5


def mode_configs(**budgets) -> dict:
    """{mode: PipelineConfig} at the given budgets (production by default)."""
    from gcslam_torch.models.config import PipelineConfig

    return {name: PipelineConfig(**budgets, **over) for name, over in MODES.items()}


def hard_regime(n_scans: int, n_points: int):
    """The synthetic world of the ablation."""
    from gcslam_torch.frontend.synthetic import SyntheticConfig

    return SyntheticConfig(n_scans=n_scans, n_points=n_points, **REGIME)


def run_mode(cfg, run, device) -> dict:
    """One mode over the whole run, after a warm-up on its first scans."""
    import numpy as np
    import torch

    from gcslam_torch.eval import ate_rpe
    from gcslam_torch.models import runner
    from gcslam_torch.ops import sinkhorn

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg.validate()
    t0 = time.perf_counter()
    runner.run_bag(run.batches[:N_WARMUP], cfg, device=device)
    sync()
    warmup_s = time.perf_counter() - t0
    sinkhorn.COUNTER.reset()
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg, device=device)
    sync()
    ms = (time.perf_counter() - t0) / len(run.batches) * 1e3
    poses = out.pose.double().cpu().numpy()
    ate = ate_rpe.compute_ate(poses, run.gt_poses, align="initial")
    return {
        "warmup_s": round(warmup_s, 3),
        "ms_per_scan": round(ms, 3),
        "ate_trans_rmse_m": round(ate["translation"]["rmse"], 4),
        "ate_rot_rmse_deg": round(ate["rotation_deg"]["rmse"], 3),
        "sinkhorn_launches": sinkhorn.COUNTER.launches if device.type == "cuda" else None,
        "finite": bool(np.all(np.isfinite(poses))),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gcslam_torch.tools.ablate_gn_shared")
    p.add_argument("--scans", type=int, default=80)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    if str(BELIEF_DTYPE) != "torch.float32":
        os.execve(sys.executable, [sys.executable, "-m", "gcslam_torch.tools.ablate_gn_shared"]
                  + list(sys.argv[1:] if argv is None else argv),
                  dict(os.environ, GCSLAM_BELIEF_DTYPE="float32"))

    from gcslam_torch.frontend.synthetic import generate
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    configs = mode_configs()
    run = generate(hard_regime(args.scans, configs["shared"].n_points_cap), device=device)
    out = {"device": device.type, "scans": args.scans, "belief_dtype": "float32",
           "regime": "circuit + dead-reckoned odom (0.05 m/m, 0.02 rad/m)"}
    for name, cfg in configs.items():
        out[name] = run_mode(cfg, run, device)
        print(name, json.dumps(out[name]), flush=True)

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
