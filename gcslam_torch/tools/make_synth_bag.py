"""Write a full-length real-schema Kimera-like rosbag + TUM ground truth
(frontend/bag_synth.py) for the production-path rehearsal (counterpart of
the JAX package's tools/make_synth_bag.py, same flags and defaults):

  python -m gcslam_torch.tools.make_synth_bag --out results/kimera_synth.db3 \\
      --gt results/kimera_synth_gt.tum --config configs/gc_kimera.yaml \\
      --scans 160 --trajectory circuit --odom-model integrated
  python -m gcslam_torch.eval.run --bag results/kimera_synth.db3 \\
      --config configs/gc_kimera.yaml --gt results/kimera_synth_gt.tum \\
      --chunk 10 --loop --out results/kimera_rehearsal

The bag carries the config's topic names, extrinsic frames, camera
intrinsics and inverse-skewed per-topic clocks, so the eval path runs the
whole frontend as the canonical bag would (the reference's single test
path, tools/run_and_evaluate_gc.sh:333-645). Its rows are byte for byte
those of the JAX package's tool on the same arguments. Host work only
(numpy, PIL, sqlite): no device is used.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gcslam_torch.tools.make_synth_bag")
    p.add_argument("--out", required=True, help="output .db3 path")
    p.add_argument("--gt", default=None, help="output TUM ground-truth path")
    p.add_argument("--config", default=None,
                   help="run config whose frontend: section fixes topics/extrinsics/intrinsics "
                        "(configs/gc_kimera.yaml)")
    p.add_argument("--scans", type=int, default=160)
    p.add_argument("--points", type=int, default=16384,
                   help="raw points per scan BEFORE the frontend's budget resample (VLP-16 emits ~29k/scan "
                        "at 10 Hz)")
    p.add_argument("--trajectory", default="circuit", choices=["ramp", "circuit"])
    p.add_argument("--odom-model", default="integrated", choices=["additive", "integrated"])
    p.add_argument("--drift", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-camera", action="store_true")
    p.add_argument("--cam-rate", type=float, default=10.0)
    p.add_argument("--cam-w", type=int, default=640)
    p.add_argument("--cam-h", type=int, default=480)
    args = p.parse_args(argv)

    from gcslam_torch.frontend import rosbag
    from gcslam_torch.frontend.bag_synth import write_synth_bag
    from gcslam_torch.frontend.synthetic import SyntheticConfig

    bag_cfg = rosbag.bag_config_from_file(args.config) if args.config else None
    if bag_cfg is None:
        bag_cfg = rosbag.BagConfig()
    if args.no_camera:
        bag_cfg = dataclasses.replace(bag_cfg, with_camera=False)
    if bag_cfg.with_camera and bag_cfg.camera_intrinsics is None:
        raise SystemExit("camera enabled but config has no camera_intrinsics")

    cfg = SyntheticConfig(
        n_scans=args.scans,
        n_points=args.points,
        trajectory=args.trajectory,
        odom_model=args.odom_model,
        odom_drift_pos_per_m=args.drift,
        odom_drift_yaw_per_m=args.drift / 2,
        seed=args.seed,
    )
    summary = write_synth_bag(args.out, cfg, bag_cfg, gt_path=args.gt, cam_rate_hz=args.cam_rate,
                              cam_size=(args.cam_w, args.cam_h), progress=True)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
