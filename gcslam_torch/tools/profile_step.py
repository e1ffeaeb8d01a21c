"""Cost and timing of the scan step (counterpart of the JAX package's
tools/profile_step.py). The JAX tool reads a compiled XLA program: its
lower and compile times, XLA's cost and memory analysis and the optimized
module's op histogram. The port's step is eager, so each has a measured
counterpart:

  - first_scan_s: the first step from a fresh state, read back, including
    loading the kernels' libraries (and building any that is not built
    yet): the JAX tool's lower_s + compile_s;
  - compute: models/manifest.compute_cert on one step (the FLOPs of its
    matrix products, argument and output bytes, peak device memory): the
    JAX tool's cost_analysis and memory_analysis;
  - timing: StepTimer percentiles over --steps eager steps, each ending
    in a synchronize of the card;
  - graph (on the card): the same steps as replays of the compiled step
    (models/runner.CompiledStep, what the runners run there): its first
    step (eager, then the capture) and capture seconds, and the timing of
    the replays after it; the JAX tool's step is its jitted program;
  - graph.stages (on the card): the compiled step's stage clock
    (utils/profiling.StageClock) over one run_bag of the timed scans
    replayed again back to back, as the runners replay them (the timed
    replays each wait for the card): the device ms a scan in each stage of
    the step, and the share of the call's device span spent between steps
    (the scans' staging and the replays' launches). This is the clock's
    reader outside the benchmark;
  - top_kernels: the 15 most-launched kernel names in one profiled step
    (utils/cuda_profile), or on the CPU the 15 most-dispatched aten ops:
    the JAX tool's hlo_top_ops;
  - lie_launches_per_scan: the launches of csrc/se3.cu's Lie-group kernel
    a scan by op (ops/se3.LIE_COUNTER), in the profiled eager step and
    (on the card) over graph.stages' replays: one a call of the maps and
    of linalg.inv3x3, which shows that the step goes through the kernel
    (none on the CPU, where the plain versions run);
  - finite: whether the last pose is finite.
--trace DIR writes a torch.profiler Chrome trace of the timed steps.

Usage:
  python -m gcslam_torch.tools.profile_step [--cpu] [--steps 20] [--small]
         [--points 8192] [--no-map] [--trace DIR]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time

TOP_KERNELS = 15


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--small", action="store_true", help="small map budgets")
    p.add_argument("--no-map", action="store_true")
    p.add_argument("--trace", default=None, metavar="DIR", help="write a torch.profiler Chrome trace")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.manifest import compute_cert
    from gcslam_torch.models.scan_step import init_state, scan_step
    from gcslam_torch.ops import se3
    from gcslam_torch.utils import cuda_profile
    from gcslam_torch.utils.device import resolve_device
    from gcslam_torch.utils.profiling import COUNTERS, StepTimer, trace

    device = resolve_device("cpu" if args.cpu else None)
    kw = dict(with_map=not args.no_map)
    if args.small and not args.no_map:
        kw.update(atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)
    cfg = PipelineConfig(**kw)
    # scan 0 the first step, 1 the compute certificate, 2 the profiled
    # step, then the timed steps
    run = generate(SyntheticConfig(n_scans=args.steps + 3, n_points=args.points), device="cpu")
    batches = [COUNTERS.to_device(b, device) for b in run.batches]
    step = torch.no_grad()(lambda s, b: scan_step(s, b, cfg))

    t0 = time.perf_counter()
    state, out = step(init_state(cfg, device=device), batches[0])
    COUNTERS.to_host(out.pose)
    first_scan_s = time.perf_counter() - t0

    compute, (state, out) = compute_cert(step, state, batches[1])

    profiled = []
    lie_before = se3.LIE_COUNTER.snapshot()
    if device.type == "cuda":
        prof, _ = cuda_profile.profile(lambda: profiled.append(step(state, batches[2])), ("cuda",))
        top = cuda_profile.kernel_counts(prof)
    else:
        prof, _ = cuda_profile.profile(lambda: profiled.append(step(state, batches[2])), ("cpu",))
        top = collections.Counter({e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")})
    state, out = profiled[0]
    lie = {"eager": se3.launches_by_op(since=lie_before), "graph": None}

    timer = StepTimer()
    with trace(args.trace) if args.trace else contextlib.nullcontext():
        for b in batches[3:]:
            with timer.measure(out_ref=b):
                state, out = step(state, b)

    graph = None
    if device.type == "cuda":
        from gcslam_torch.models import runner

        loop = runner.StepLoop(cfg, state, len(batches) - 3)
        gtimer = StepTimer()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, gout = loop.step(batches[3])
            torch.cuda.synchronize(device)
            first_s = time.perf_counter() - t0
            for b in batches[4:]:
                with gtimer.measure(out_ref=b):
                    _, gout = loop.step(b)
        graph = {"first_scan_s": round(first_s, 3), "capture_s": round(loop.compiled.capture_s, 3),
                 "timing": gtimer.summary(), "finite": bool(np.all(np.isfinite(COUNTERS.to_host(gout.pose))))}
        if batches[4:]:
            clock = loop.compiled.stage_clock
            clock.reset()
            lie_before = se3.LIE_COUNTER.snapshot()
            runner.run_bag(batches[4:], cfg, state=loop.result()[0], device=device)
            reading = clock.read()
            lie["graph"] = {op: n / len(batches[4:]) for op, n in se3.launches_by_op(since=lie_before).items()}
            graph["stages"] = {"ms_per_scan": {k: round(v, 4) for k, v in reading.ms_per_scan.items()},
                               "between_steps_share": round(reading.between_share, 5),
                               "between_ms_per_scan": round(reading.between_ms_per_scan, 4),
                               "scans": reading.scans}

    report = {
        "device": device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "first_scan_s": round(first_scan_s, 3),
        "timing": timer.summary(),
        "graph": graph,
        "compute": compute,
        "top_kernels": dict(top.most_common(TOP_KERNELS)),
        "lie_launches_per_scan": lie,
        "finite": bool(np.all(np.isfinite(COUNTERS.to_host(out.pose)))),
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
