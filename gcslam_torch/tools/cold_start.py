"""Boot time of a fresh process: seconds from its start to its first pose
(counterpart of the JAX package's tools/cold_start.py).

A deploy runs tools/warm_cache once, which builds the native libraries
into gcslam_torch/csrc/build/; every later process loads them. This tool
runs warm_cache in a child process (unless --skip-warm: it already ran),
then spawns one fresh process and records its milestones, in seconds
since that process started:
  import_done  — torch and gcslam_torch imported;
  data_ready   — 10 synthetic scans generated on the host;
  first_pose_s — run_stream's first pose read back (the live-robot boot
                 metric): the first scan committed, the kernels' libraries
                 loaded and the step run;
  chunk_pose_s — additionally, a run_chunked window of the 10 scans from a
                 fresh state, its poses read back;
and native_builds, the libraries the child compiled before its first pose
(from the transfer ledger): 0 in a warmed deploy.

  python -m gcslam_torch.tools.cold_start [--json PATH] [--skip-warm] [--cpu]

The report goes to stdout, and to --json PATH when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_SCANS = 10

_CHILD = r"""
import json, sys, time
T0 = time.time()
import torch
import gcslam_torch
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.utils.profiling import COUNTERS
from gcslam_torch.utils.device import resolve_device
args = json.loads(sys.argv[1])
m = {"import_done": round(time.time() - T0, 3)}
device = resolve_device("cpu" if args["cpu"] else None)
cfg = PipelineConfig(**args["config"])
cfg.validate()
run = generate(SyntheticConfig(n_scans=args["scans"], n_points=args["points"] or cfg.n_points_cap), device="cpu")
m["data_ready"] = round(time.time() - T0, 3)
_, out = runner.run_stream(run.batches[:1], cfg, device=device)
_ = float(COUNTERS.to_host(out.pose)[0, 0])
m["first_pose_s"] = round(time.time() - T0, 3)
m["native_builds"] = COUNTERS.cert()["native_builds"]
_, out2 = runner.run_chunked(run.batches, cfg, chunk=args["scans"], device=device)
_ = float(COUNTERS.to_host(out2.pose).ravel()[0])
m["chunk_pose_s"] = round(time.time() - T0, 3)
m["device"] = device.type
print("CHILD_JSON " + json.dumps(m))
"""


def measure(cpu: bool = False, skip_warm: bool = False, config=None, n_points=None, n_scans: int = N_SCANS) -> dict:
    """warm_cache (unless skip_warm), then one fresh child process; the
    PipelineConfig fields `config` and `n_points` size the child's run
    (default: PipelineConfig() at its point budget)."""
    report = {}
    if not skip_warm:
        t0 = time.time()
        cmd = [sys.executable, "-m", "gcslam_torch.tools.warm_cache"] + (["--cpu"] if cpu else [])
        r = subprocess.run(cmd, cwd=REPO)
        report["warm_cache_s"] = round(time.time() - t0, 1)
        report["warm_cache_rc"] = r.returncode
    child_args = json.dumps({"cpu": cpu, "config": dict(config or {}), "points": n_points, "scans": n_scans})
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", _CHILD, child_args], cwd=REPO, capture_output=True, text=True,
                       timeout=1800)
    report["fresh_process_wall_s"] = round(time.time() - t0, 2)
    for line in r.stdout.splitlines():
        if line.startswith("CHILD_JSON "):
            report.update(json.loads(line[len("CHILD_JSON "):]))
    report["rc"] = r.returncode
    if r.returncode != 0:
        report["stderr_tail"] = r.stderr[-2000:]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--skip-warm", action="store_true", help="assume tools/warm_cache already ran")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    report = measure(cpu=args.cpu, skip_warm=args.skip_warm)
    out = json.dumps(report, indent=1)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    return 0 if report["rc"] == 0 and report.get("warm_cache_rc", 0) == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
