"""Build and load the port's native libraries, then run the flagship step
and one chunk (counterpart of the JAX package's tools/warm_cache.py, the
deploy-time step before a robot or eval.run boots).

The JAX tool compiles the pipeline's XLA programs into a persistent cache.
The port's step builds nothing per config on disk (on the card each
process captures its compiled step, a CUDA graph, at its first scan of a
config): what a fresh process would otherwise build is its five native
libraries, each into gcslam_torch/csrc/build/ under a name that hashes its
source and flags:

  - csrc/sinkhorn.cu, csrc/raster.cu, csrc/eigh.cu and csrc/stage_clock.cu
    (the compiled step's stage clock), with nvcc for sm_90a (the card);
  - csrc/bag_decode.cpp, with g++ (the host).
It reports, for each, whether it was already built and the seconds to
build (when it was not) and load it; then the seconds of one flagship
step from a fresh state (`step_s`, its pose read back) and of one
run_chunked window of --chunk scans (`chunked_s`), and with --camera of
one camera-path step (`camera_step_s`); and the libraries this process
compiled (`native_builds`, from the transfer ledger).

--cpu builds the host library alone and runs the step and the chunk on
the CPU. Without --cpu the kernels are built with nvcc: where there is
none, or no card, it raises.

Usage:
  python -m gcslam_torch.tools.warm_cache [--chunk 10] [--camera] [--cpu]
         [--config PATH] [--json PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def libraries(cpu: bool):
    """name -> (library path, build-and-load function) for the libraries
    of the route: the host decoder alone with cpu."""
    from gcslam_torch.frontend import native
    from gcslam_torch.ops import eigh, sinkhorn
    from gcslam_torch.outputs import raster
    from gcslam_torch.utils.profiling import stamp_library

    libs = {"bag_decode": (native.library_path, native.library)}
    if not cpu:
        libs.update(sinkhorn=(sinkhorn.library_path, sinkhorn.load), raster=(raster.library_path, raster.load),
                    eigh=(eigh.library_path, eigh.load), stage_clock=(stamp_library().path, stamp_library().lib))
    return libs


def warm(cfg, device, chunk: int = 10, camera: bool = False, n_points=None) -> dict:
    """Build and load the libraries, then time one step and one chunk."""
    import torch

    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.utils.profiling import COUNTERS

    report = {"device": device.type, "chunk": chunk, "libraries": {}}
    for name, (path, load) in libraries(device.type == "cpu").items():
        built = path().exists()
        t0 = time.perf_counter()
        load()
        report["libraries"][name] = {"already_built": built, "s": round(time.perf_counter() - t0, 3),
                                     "path": path().name}

    def timed(key, fn):
        t0 = time.perf_counter()
        fn()
        report[key] = round(time.perf_counter() - t0, 3)
        print(f"warmed {key}: {report[key]} s", flush=True)

    pts = n_points or cfg.n_points_cap
    run = generate(SyntheticConfig(n_scans=chunk, n_points=pts), device="cpu")
    timed("step_s", lambda: COUNTERS.to_host(runner.run_stream(run.batches[:1], cfg, device=device)[1].pose))
    timed("chunked_s", lambda: COUNTERS.to_host(runner.run_chunked(run.batches, cfg, chunk=chunk,
                                                                   device=device)[1].pose))
    if camera:
        cfg_cam = dataclasses.replace(cfg, with_camera=True)
        cfg_cam.validate()
        cam = generate(SyntheticConfig(n_scans=1, n_points=pts, with_camera=True), device="cpu")
        timed("camera_step_s", lambda: COUNTERS.to_host(runner.run_stream(cam.batches, cfg_cam,
                                                                          device=device)[1].pose))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    report["native_builds"] = COUNTERS.cert()["native_builds"]
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--chunk", type=int, default=10, help="scans of the run_chunked window (bench.py: 10)")
    p.add_argument("--camera", action="store_true", help="also run the with_camera step")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--config", default=None, help="YAML/JSON PipelineConfig")
    p.add_argument("--json", default=None, metavar="PATH")
    args = p.parse_args(argv)

    from gcslam_torch.models.config import PipelineConfig, config_from_file
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = config_from_file(args.config) if args.config else PipelineConfig()
    cfg.validate()
    report = warm(cfg, device, chunk=args.chunk, camera=args.camera)
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
