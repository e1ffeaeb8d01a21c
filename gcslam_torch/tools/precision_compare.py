"""f32-vs-f64 belief precision on one device (counterpart of the JAX
package's tools/precision_compare.py): the same production-budget replay
(PipelineConfig() on the synthetic world, 8192 points a scan) under both
belief dtypes, with the ATE and the certificate fields that back the
precision policy (those of PRECISION_r05.json).

  python -m gcslam_torch.tools.precision_compare [--scans 50] [--json PATH] [--cpu]

The belief dtype binds when the package is imported, so each dtype runs in
a child process started with GCSLAM_BELIEF_DTYPE set. A child runs the
replay twice: the first run ("first_run_s") builds the kernels and warms
the allocator, the second is timed ("ms_per_scan", synchronized host
clock). The report is printed, and written only where --json says (the
default is under results/, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEFAULT_JSON = os.path.join("results", "precision_compare.json")


def certificate_fields(tape) -> dict:
    """The certificate fields of PRECISION_r05.json over a run's tape."""
    def g(x):
        return x.double().cpu().numpy()

    return {
        "eigmin_pose6_min": float(g(tape.eigmin_pose6).min()),
        "eigmin_pose6_mean": float(g(tape.eigmin_pose6).mean()),
        "cond_pose6_max": float(g(tape.cond_pose6).max()),
        "cond_pose6_mean": float(g(tape.cond_pose6).mean()),
        "psd_projection_delta_max": float(g(tape.influence_psd_projection_delta).max()),
        "psd_projection_delta_mean": float(g(tape.influence_psd_projection_delta).mean()),
        "trigger_mag_total": float(g(tape.total_trigger_magnitude).sum()),
    }


def run_one(dtype: str, scans: int, device) -> dict:
    import numpy as np
    import torch

    from gcslam_torch.eval import ate_rpe
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import sinkhorn
    from gcslam_torch.utils.device import resolve_device
    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    if str(BELIEF_DTYPE) != f"torch.{dtype}":
        raise RuntimeError(f"the package was imported with belief dtype {BELIEF_DTYPE}, not {dtype}")
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = PipelineConfig()
    run = generate(SyntheticConfig(n_scans=scans, n_points=cfg.n_points_cap), device=device)
    t0 = time.perf_counter()
    runner.run_bag(run.batches, cfg, device=device)
    sync()
    first_s = time.perf_counter() - t0
    sinkhorn.COUNTER.reset()
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg, device=device)
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / scans
    poses = out.pose.double().cpu().numpy()
    ate = ate_rpe.compute_ate(poses, run.gt_poses, align="initial")
    return {
        "belief_dtype": dtype,
        "device": device.type,
        "first_run_s": first_s,
        "ms_per_scan": ms,
        "sinkhorn_launches": sinkhorn.COUNTER.launches if device.type == "cuda" else None,
        "ate_trans_rmse_m": ate["translation"]["rmse"],
        "ate_rot_rmse_deg": ate["rotation_deg"]["rmse"],
        **certificate_fields(out.tape),
        "finite": bool(np.all(np.isfinite(poses))),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gcslam_torch.tools.precision_compare")
    p.add_argument("--scans", type=int, default=50)
    p.add_argument("--json", default=DEFAULT_JSON)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--dtype", default=None, help=argparse.SUPPRESS)  # child mode
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.dtype:
        from gcslam_torch.utils.dtypes import BELIEF_DTYPE

        if str(BELIEF_DTYPE) != f"torch.{args.dtype}":
            os.execve(sys.executable, [sys.executable, "-m", "gcslam_torch.tools.precision_compare"]
                      + list(sys.argv[1:] if argv is None else argv),
                      dict(os.environ, GCSLAM_BELIEF_DTYPE=args.dtype))
        print(json.dumps(run_one(args.dtype, args.scans, device)), flush=True)
        return {}

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = {}
    for dtype in ("float32", "float64"):
        cmd = [sys.executable, "-m", "gcslam_torch.tools.precision_compare", "--dtype", dtype,
               "--scans", str(args.scans)] + (["--cpu"] if args.cpu else [])
        env = dict(os.environ, GCSLAM_BELIEF_DTYPE=dtype,
                   PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
        r = subprocess.run(cmd, capture_output=True, text=True, env=env)
        lines = [line for line in r.stdout.splitlines() if line.startswith("{")]
        out[dtype] = json.loads(lines[-1]) if r.returncode == 0 and lines else {"error": (r.stderr or r.stdout)[-500:]}
        print(dtype, json.dumps(out[dtype]), flush=True)

    f32, f64 = out["float32"], out["float64"]
    if "error" not in f32 and "error" not in f64:
        out["delta"] = {
            "ate_trans_rmse_m": f32["ate_trans_rmse_m"] - f64["ate_trans_rmse_m"],
            "ate_rot_rmse_deg": f32["ate_rot_rmse_deg"] - f64["ate_rot_rmse_deg"],
            "latency_ratio": f64["ms_per_scan"] / max(f32["ms_per_scan"], 1e-9),
        }
        print("delta", json.dumps(out["delta"]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
