"""Per-stage cost of the scan step by config deltas (counterpart of the
JAX package's tools/attribute_step.py): run the step under a family of
config variants that each disable or shrink one stage, measure its
steady-state time, and report each variant's delta against the base.

On the card the step is eager PyTorch: a stage costs the host time to
launch its kernels plus whatever device time the launches do not hide, and
a variant's delta measures both in context. Per variant:
  - ms_p50 / ms_mean: per-step host-clock time of the eager step, each
    step ending in torch.cuda.synchronize(); with --replay N instead
    ms_per_scan, an N-scan run_bag timed the same way (on the card
    run_bag replays the compiled step, models/runner.CompiledStep);
  - ms_read: the time of a device-to-host read of one pose value (what the
    JAX tool reads to anchor its timestamps);
  - first_call_s: the first scan, including the one-time nvcc build of
    the kernels when their libraries are not built yet (the JAX tool's
    compile_s, which has no counterpart: nothing is compiled per config);
  - launch_calls_per_scan and device_busy_ms_per_scan (with the other
    fields of utils/cuda_profile's record), from torch.profiler over
    `PROFILE_SCANS` eager steps (with --replay too: a graph replay is one
    launch call whatever the variant): the runtime's kernel-launch calls
    and the device's summed kernel, copy and set time per scan, in place of the
    JAX tool's XLA cost analysis (gflops, gbytes), which has no
    counterpart for an eager step (None on the CPU);
  - sinkhorn_launches_per_scan: the Sinkhorn kernel's launch counter
    (None on the CPU, where the plain loop runs).

Variants (each toggles one knob off the production base):
  no_map        with_map=False          -> whole map branch + map update
  gn_1round     map_icp_iters=1         -> per-GN-round association/evidence
  full_pool     k_shortlist=0           -> shortlist vs full-pool cost tile
  no_merge      k_merge_pairs_tile=0    -> merge-reduce
  view_256      m_tile_view=256         -> view-size-proportional work
  tiles_32      atlas_max_tiles=32      -> atlas-size-proportional work
and the others of VARIANTS. `exact_shortlist` is the base itself here: the
port's shortlist is always exact. The `_env` variants change a budget that
binds at import (GCSLAM_K_SINKHORN, GCSLAM_K_HYP) and run in a child
process.

Usage:
  python -m gcslam_torch.tools.attribute_step [--cpu] [--steps 10]
         [--points 8192] [--small] [--replay N] [--variants no_map,...]
         [--json out.json] [--precision f32|f64]

--precision (default f32, as the JAX tool) sets the belief dtype, which
binds when the package is imported: the process runs itself anew with
GCSLAM_BELIEF_DTYPE set where the dtype differs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

VARIANTS = {
    "no_map": {"with_map": False},
    "gn_1round": {"map_icp_iters": 1},
    "full_pool": {"k_shortlist": 0},
    "no_merge": {"k_merge_pairs_tile": 0},
    "view_256": {"m_tile_view": 256},
    "tiles_32": {"atlas_max_tiles": 32},
    # budgets that bind at import: measured in a child process with the
    # sanctioned GCSLAM_* override set
    "sinkhorn_10": {"_env": {"GCSLAM_K_SINKHORN": "10"}},
    "sinkhorn_20": {"_env": {"GCSLAM_K_SINKHORN": "20"}},
    "hyp_1": {"_env": {"GCSLAM_K_HYP": "1"}},
    "hyp_2": {"_env": {"GCSLAM_K_HYP": "2"}},
    "surfel_512": {"n_surfel": 512},
    "m_tile_1024": {"m_tile": 1024},
    "shortlist_16": {"k_shortlist": 16},
    "exact_shortlist": {},  # the port's shortlist is always exact
    "no_share": {"map_share_extraction": False, "map_gn_shared": False},
    "per_hyp_gn": {"map_gn_shared": False},
    "camera_on": {"with_camera": True},
    "insert_1": {"k_insert_tile": 1},
    "view_512": {"m_tile_view": 512},
    "gn_3rounds": {"map_icp_iters": 3},
}
# the JAX tool's fields with no counterpart, and the fields in their place
IN_PLACE_OF = {"compile_s": "first_call_s", "gflops": "launch_calls_per_scan", "gbytes": "device_busy_ms_per_scan"}
PROFILE_SCANS = 2


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(fn, n_scans: int, device) -> dict:
    """utils/cuda_profile's record of fn() (n_scans scans), the CUDA
    activity alone (host ops untraced: ~15 s a scan less); None on the CPU."""
    from gcslam_torch.utils import cuda_profile

    if device.type != "cuda":
        return dict.fromkeys(cuda_profile.FIELDS)
    return cuda_profile.profile_record(fn, n_scans, activities=("cuda",))


def measure_replay(cfg, batches, device) -> dict:
    """ms/scan of an N-scan run_bag after a first one (build + warm-up)."""
    from gcslam_torch.models import runner
    from gcslam_torch.ops import sinkhorn

    n = len(batches)

    def replay():
        return runner.run_bag(batches, cfg, device=device)

    t0 = time.perf_counter()
    replay()
    _sync(device)
    rep = {"first_call_s": round(time.perf_counter() - t0, 3)}
    sinkhorn.COUNTER.reset()
    t0 = time.perf_counter()
    replay()
    _sync(device)
    rep["ms_per_scan"] = round((time.perf_counter() - t0) / n * 1e3, 3)
    rep["sinkhorn_launches_per_scan"] = sinkhorn.COUNTER.launches / n if device.type == "cuda" else None
    span = [b.to(device) for b in batches[:PROFILE_SCANS]]
    rep.update(profile(lambda: runner.eager_steps(runner.init_state(cfg, device=device), span, cfg), PROFILE_SCANS,
                       device))
    return rep


def measure(cfg, batches, steps: int, device) -> dict:
    """Per-step times: the first step, then `steps` timed steps (the state
    threads through so the map grows), each ending in a synchronize."""
    import torch

    from gcslam_torch.models.scan_step import init_state, scan_step
    from gcslam_torch.ops import sinkhorn

    with torch.no_grad():
        state = init_state(cfg, device=device)
        t0 = time.perf_counter()
        state, out = scan_step(state, batches[0].to(device), cfg)
        _sync(device)
        rep = {"first_call_s": round(time.perf_counter() - t0, 3)}
        t0 = time.perf_counter()
        for _ in range(5):
            float(out.pose[0])
        rep["ms_read"] = round((time.perf_counter() - t0) / 5 * 1e3, 3)
        on_device = [b.to(device) for b in batches[1:]]
        times = []
        sinkhorn.COUNTER.reset()
        for i in range(steps):
            t0 = time.perf_counter()
            state, out = scan_step(state, on_device[i % len(on_device)], cfg)
            _sync(device)
            times.append(time.perf_counter() - t0)
        rep["sinkhorn_launches_per_scan"] = sinkhorn.COUNTER.launches / steps if device.type == "cuda" else None

        def more():
            nonlocal state
            for b in on_device[:PROFILE_SCANS]:
                state, _ = scan_step(state, b, cfg)

        rep.update(profile(more, PROFILE_SCANS, device))
    times.sort()
    rep["ms_p50"] = round(times[len(times) // 2] * 1e3, 3)
    rep["ms_mean"] = round(sum(times) / len(times) * 1e3, 3)
    return rep


def _child(name: str, env: dict, args) -> dict:
    """The base of an `_env` variant, measured in a child process."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "child.json")
        cmd = [sys.executable, "-m", "gcslam_torch.tools.attribute_step", "--variants", "", "--json", path,
               "--points", str(args.points), "--steps", str(args.steps), "--precision", args.precision]
        cmd += (["--replay", str(args.replay)] if args.replay else []) + (["--cpu"] if args.cpu else [])
        cmd += ["--small"] if args.small else []
        env = dict(os.environ, **env, PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
        r = subprocess.run(cmd, env=env, capture_output=True, text=True)
        try:
            with open(path) as f:
                return json.load(f)["base"]
        except (OSError, ValueError, KeyError):
            return {"error": f"{name}: " + (r.stderr or r.stdout)[-200:]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gcslam_torch.tools.attribute_step")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--small", action="store_true", help="small map budgets (test mode)")
    p.add_argument("--replay", type=int, default=0, metavar="N",
                   help="time an N-scan run_bag per variant instead of single steps")
    p.add_argument("--variants", default=",".join(VARIANTS), help="comma list from: " + ",".join(VARIANTS))
    p.add_argument("--json", default=None, metavar="PATH")
    p.add_argument("--precision", default="f32", choices=["f32", "f64"],
                   help="belief-algebra dtype (default f32, as the JAX tool)")
    args = p.parse_args(argv)

    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    want = "float32" if args.precision == "f32" else "float64"
    if str(BELIEF_DTYPE) != f"torch.{want}":
        # BELIEF_DTYPE bound at the package's import: run anew with it set
        os.execve(sys.executable, [sys.executable, "-m", "gcslam_torch.tools.attribute_step"]
                  + list(sys.argv[1:] if argv is None else argv),
                  dict(os.environ, GCSLAM_BELIEF_DTYPE=want))

    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    base_kw = {}
    if args.small:
        base_kw = dict(atlas_max_tiles=16, m_tile=256, m_tile_view=128, n_surfel=256, surfel_voxel_size_m=0.4)
    cfg0 = PipelineConfig(**base_kw)
    n_scans = args.replay if args.replay else max(args.steps + 1, 4)
    variants = [v for v in args.variants.split(",") if v]
    run = generate(SyntheticConfig(n_scans=n_scans, n_points=min(args.points, cfg0.n_points_cap)), device=device)

    def measure_fn(cfg):
        if args.replay:
            return measure_replay(cfg, run.batches, device)
        return measure(cfg, run.batches, args.steps, device)

    out = {"device": device.type, "replay": args.replay, "belief_dtype": str(BELIEF_DTYPE).replace("torch.", ""),
           "base_budgets": {"atlas": f"{cfg0.atlas_max_tiles}x{cfg0.m_tile}", "view": cfg0.m_tile_view,
                            "k_shortlist": cfg0.k_shortlist, "gn_rounds": cfg0.map_icp_iters}}
    out["base"] = measure_fn(cfg0)
    print("base", json.dumps(out["base"]), flush=True)

    key = "ms_per_scan" if args.replay else "ms_p50"
    for name in variants:
        over = VARIANTS[name]
        if name == "view_256" and cfg0.m_tile_view <= 256:
            continue  # small mode: the variant is not meaningful
        if name == "tiles_32" and cfg0.atlas_max_tiles <= 32:
            continue
        if "_env" in over:
            out[name] = _child(name, over["_env"], args)
        else:
            try:
                cfg = dataclasses.replace(cfg0, **over)
                cfg.validate()
                out[name] = measure_fn(cfg)
            except (ValueError, RuntimeError) as e:
                out[name] = {"error": str(e)[:200]}
        if key in out[name]:
            out[name]["delta_ms"] = round(out["base"][key] - out[name][key], 3)
        print(name, json.dumps(out[name]), flush=True)

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
