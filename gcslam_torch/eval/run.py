"""The test path of the port (counterpart of the JAX package's eval/run.py):
run the pipeline on a bag (or the synthetic rig), score it, and emit every
artifact — the replacement for the reference's
tools/run_and_evaluate_gc.sh:

  <out>/
    runtime_manifest.json   (startup contract echo, with the device)
    trajectory.tum          (/gc/trajectory)
    ground_truth.tum
    diagnostics.npz         (per-scan ScanTape)
    splat_export.npz        (atlas as renderable splats)
    metrics.json            (ATE/RPE, timing) + metrics.csv
    dashboard.html          (trajectory + certificate sentinels)
    map_events.jsonl        (per-scan map maintenance event log)
    audit.json              (post-run invariant audit)

Usage:
  python -m gcslam_torch.eval.run --bag <db3|mcap> --config configs/gc_kimera.yaml \\
      --gt <tum> --out <dir> [--cpu] [--no-camera] [--loop] [--chunk W] [--map-stream N]
  python -m gcslam_torch.eval.run --scans 160 --out <dir>   (synthetic rig)

The run is on the CUDA card unless --cpu is given; without a card it
raises. --precision f32 runs the belief algebra in float32 (the JAX
package's production mode): the process re-executes itself with
GCSLAM_BELIEF_DTYPE set, since the dtype binds at import. --live-view DIR
streams the run to outputs/live_view (a rerun recording with the SDK, else
DIR/live.jsonl and npz snapshots; 'spawn' pops a rerun viewer); it runs
with every runner mode (the JAX package's drops it under --chunk).
GCSLAM_NO_NATIVE=1 decodes the bag with the Python codec and the pure
camera route, as the JAX package's switch does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gcslam_torch.eval.run")
    p.add_argument("--out", default=None)
    p.add_argument("--scans", type=int, default=160)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--bag", default=None, help="rosbag2 .db3/.mcap path (else synthetic)")
    p.add_argument("--gt", default=None, help="ground-truth TUM file for a bag run")
    p.add_argument("--no-map", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--drift", type=float, default=0.05, help="synthetic odom drift per sqrt(m)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--align", default="initial", choices=["initial", "umeyama", "none"])
    p.add_argument("--mode", default=None, choices=["absolute", "relative"],
                   help="odometry pose factor mode (default: config file else absolute)")
    p.add_argument("--loop", action="store_true", help="produce loop-closure factors (streaming mode)")
    p.add_argument("--chunk", type=int, default=0, metavar="W",
                   help="chunked streaming: windows of W scans with loop-closure injection at "
                        "chunk boundaries (combines with --loop)")
    p.add_argument("--live-view", default=None, metavar="DIR|spawn",
                   help="live visualization: with the rerun SDK 'spawn' pops a viewer; otherwise DIR "
                        "receives a tail-able live.jsonl + point/map snapshots")
    p.add_argument("--map-stream", type=int, default=0, metavar="N",
                   help="export incremental map snapshots every N scans (streaming mode)")
    p.add_argument("--no-camera", dest="camera", action="store_false", default=None,
                   help="force the camera path OFF (overrides the config)")
    p.add_argument("--frontend-set", action="append", default=[], metavar="KEY=VAL",
                   help="override a BagConfig field for bag runs (repeatable; JSON values, "
                        "'none' -> None), e.g. --frontend-set anchor_smoothing_k=1")
    p.add_argument("--camera", action="store_true", default=None,
                   help="RGB-D camera + visual frontend (default: config file else off)")
    p.add_argument("--trajectory", default="ramp", choices=["ramp", "circuit"],
                   help="synthetic trajectory shape")
    p.add_argument("--odom-model", default="additive", choices=["additive", "integrated"],
                   help="synthetic wheel-odometry error model")
    p.add_argument("--config", default=None,
                   help="YAML/JSON PipelineConfig file (configs/gc_default.yaml)")
    p.add_argument("--precision", default=None, choices=["f32", "f64"],
                   help="belief-algebra dtype (default: GCSLAM_BELIEF_DTYPE, else f64); the process "
                        "re-executes itself with that variable set")
    return p


def _bag_config(args, cfg):
    """The BagConfig of a bag run: the config file's `frontend:` section (or
    defaults), with the CLI's point budget, camera switch and
    --frontend-set overrides."""
    from gcslam_torch.frontend import rosbag

    bag_cfg = rosbag.bag_config_from_file(args.config) if args.config else None
    if bag_cfg is None:
        bag_cfg = rosbag.BagConfig(n_points=args.points, with_camera=cfg.with_camera)
    else:
        bag_cfg = dataclasses.replace(bag_cfg, n_points=args.points)
    if tuple(bag_cfg.T_base_lidar) == (0.0,) * 6 and tuple(bag_cfg.T_base_imu) == (0.0,) * 6:
        print("WARNING: running a real bag with IDENTITY T_base_lidar/T_base_imu and imu_accel_scale="
              f"{bag_cfg.imu_accel_scale} — set the `frontend:` section of the run config "
              "(configs/gc_kimera.yaml is the template); wrong extrinsics corrupt every evidence factor.",
              file=sys.stderr)
    if args.camera is not None:
        bag_cfg = dataclasses.replace(bag_cfg, with_camera=args.camera)
    for kv in args.frontend_set:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--frontend-set expects KEY=VAL, got {kv!r}")
        parsed = None if val.lower() in ("none", "null") else json.loads(val)
        bag_cfg = dataclasses.replace(bag_cfg, **{key: parsed})
    if cfg.with_camera != bag_cfg.with_camera:
        raise ValueError(f"pipeline with_camera={cfg.with_camera} but frontend with_camera="
                         f"{bag_cfg.with_camera}; the two must agree")
    return bag_cfg


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.precision is not None:
        from gcslam_torch.utils.dtypes import BELIEF_DTYPE

        want = "float32" if args.precision == "f32" else "float64"
        if str(BELIEF_DTYPE) != f"torch.{want}":
            # BELIEF_DTYPE bound at the package's import: run anew with it set
            os.execve(sys.executable, [sys.executable, "-m", "gcslam_torch.eval.run"]
                      + list(sys.argv[1:] if argv is None else argv),
                      dict(os.environ, GCSLAM_BELIEF_DTYPE=want))

    import numpy as np

    from gcslam_torch.eval import ate_rpe, audit as audit_mod
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig, config_from_file
    from gcslam_torch.models.manifest import device_runtime_cert, write_manifest
    from gcslam_torch.outputs import dashboard, diagnostics, splat_export, tum
    from gcslam_torch.utils.device import resolve_device
    from gcslam_torch.utils.profiling import COUNTERS, device_runtime_cert as ledger_cert

    device = resolve_device("cpu" if args.cpu else None)
    out_dir = args.out or time.strftime("results/gc_%Y%m%d_%H%M%S")
    os.makedirs(out_dir, exist_ok=True)

    # CLI flags override the config file only when given (a default
    # --camera/--mode must not clobber the file's values)
    overrides = {}
    if args.no_map:
        overrides["with_map"] = False
    if args.mode is not None:
        overrides["odom_pose_mode"] = args.mode
    if args.camera is not None:
        overrides["with_camera"] = args.camera
    if args.config:
        cfg = config_from_file(args.config, **overrides)
    else:
        cfg = PipelineConfig(atlas_max_tiles=64, m_tile=1024, m_tile_view=256, n_surfel=512,
                             surfel_voxel_size_m=0.3,
                             **{"odom_pose_mode": "absolute", "with_camera": False, **overrides})
        cfg.validate()
    write_manifest(os.path.join(out_dir, "runtime_manifest.json"), cfg, device)

    t_load = time.perf_counter()
    if args.bag:
        from gcslam_torch.frontend import rosbag

        batches, gt_poses, gt_times = rosbag.load_bag(args.bag, config=_bag_config(args, cfg), device=device)
        if args.gt:
            from gcslam_torch.eval import gt_tools

            gt_stamps_raw, gt_raw = tum.read_tum(args.gt)
            scan_stamps = np.asarray([float(b.t_scan) for b in batches])
            gt_tools.check_time_overlap(scan_stamps, gt_stamps_raw)
            gt_poses, _gt_valid = gt_tools.interpolate_gt(gt_stamps_raw, gt_raw, scan_stamps)
            gt_times = scan_stamps
    else:
        from gcslam_torch.frontend.synthetic import SyntheticConfig, generate

        run = generate(SyntheticConfig(
            n_scans=args.scans, n_points=args.points, odom_drift_pos_per_m=args.drift,
            odom_drift_yaw_per_m=args.drift / 2, seed=args.seed, trajectory=args.trajectory,
            with_camera=bool(args.camera), odom_model=args.odom_model,
        ), device=device)
        batches, gt_poses, gt_times = run.batches, run.gt_poses, run.gt_times
    load_s = time.perf_counter() - t_load

    detector = None
    if args.loop:
        from gcslam_torch.frontend.loop import LoopDetector

        detector = LoopDetector()
    viewer = None
    if args.live_view:
        from gcslam_torch.outputs.live_view import LiveViewer

        spawn = args.live_view == "spawn"
        viewer = LiveViewer(os.path.join(out_dir, "live") if spawn else args.live_view, spawn=spawn)
    COUNTERS.reset()
    t0 = time.perf_counter()
    if args.chunk > 0:
        state, out = runner.run_chunked(batches, cfg, chunk=args.chunk, loop_detector=detector,
                                        live_viewer=viewer, device=device)
    elif args.loop or args.map_stream > 0 or viewer is not None:
        state, out = runner.run_stream(
            batches, cfg, loop_detector=detector,
            map_stream_dir=os.path.join(out_dir, "map_stream") if args.map_stream else None,
            map_stream_every=max(args.map_stream, 1),
            status_path=os.path.join(out_dir, "status.jsonl"), live_viewer=viewer, device=device)
    else:
        state, out = runner.run_bag(batches, cfg, device=device)
    poses = COUNTERS.to_host(out.pose)
    wall = time.perf_counter() - t0
    stamps = COUNTERS.to_host(out.stamp)

    tum.write_tum(os.path.join(out_dir, "trajectory.tum"), stamps, poses)
    metrics = {
        "n_scans": int(poses.shape[0]),
        "load_s": round(load_s, 3),
        "wall_s": round(wall, 3),
        "device": device.type,
        # the device inventory beside the measured transfer ledger: every
        # copy the runner made and every value read back went through it
        "device_runtime": {**device_runtime_cert(device), **ledger_cert()},
    }
    if gt_poses is not None:
        tum.write_tum(os.path.join(out_dir, "ground_truth.tum"), gt_times, gt_poses)
        metrics["ate"] = ate_rpe.compute_ate(poses, gt_poses, align=args.align)
        metrics["rpe"] = ate_rpe.compute_rpe(poses, gt_poses)

    diagnostics.save_diagnostics_npz(os.path.join(out_dir, "diagnostics.npz"), out.tape, poses, stamps)
    diagnostics.save_map_event_log(os.path.join(out_dir, "map_events.jsonl"), out.tape)
    if cfg.with_map:
        metrics["n_splats"] = splat_export.save_splat_export(os.path.join(out_dir, "splat_export.npz"),
                                                             state.atlas)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    _write_metrics_csv(os.path.join(out_dir, "metrics.csv"), metrics)
    dashboard.build_dashboard(os.path.join(out_dir, "dashboard.html"), out.tape, poses, gt_poses, metrics)

    # post-run invariant audit over the emitted artifacts (the reference
    # gates its results table on an audit, run_and_evaluate_gc.sh:491)
    audit = audit_mod.audit_run(out_dir)
    with open(os.path.join(out_dir, "audit.json"), "w") as f:
        json.dump(audit, f, indent=2)

    print(json.dumps({
        "out_dir": out_dir,
        "ate_trans_rmse": metrics.get("ate", {}).get("translation", {}).get("rmse"),
        "ate_rot_rmse_deg": metrics.get("ate", {}).get("rotation_deg", {}).get("rmse"),
        "audit_pass": bool(audit.get("all_pass", False)),
    }))
    return metrics


def _write_metrics_csv(path: str, metrics: dict) -> None:
    """Flattened key,value CSV (the reference emits metrics.{txt,csv,json})."""
    rows = []

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}" if prefix else str(k), x)
        elif isinstance(v, (int, float, bool, str)) or v is None:
            rows.append((prefix, v))

    walk("", metrics)
    with open(path, "w") as f:
        f.write("key,value\n")
        for k, v in rows:
            f.write(f"{k},{v}\n")


if __name__ == "__main__":
    main()
