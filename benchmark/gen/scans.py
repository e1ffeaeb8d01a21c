"""Scans from the seed: synthetic scan batches, and the Kimera-schema bag
file, written once per (seed, arguments) into the checkout's cache."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

from benchmark.reference.plain.frontend import bag_synth, rosbag, synthetic

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def synthetic_config(config: dict, traffic: dict, seed: int, n_scans: int) -> synthetic.SyntheticConfig:
    """The configuration's sensors and the traffic's motion, seeded."""
    fields = {**config["synthetic"], **traffic.get("synthetic", {}), "n_scans": n_scans, "seed": int(seed)}
    return synthetic.SyntheticConfig(**_tuples(fields))


def synthetic_scans(config: dict, traffic: dict, seed: int, n_scans: int, device="cpu") -> list:
    """n_scans ScanBatches (reference types) of the synthetic rig on `device`."""
    return synthetic.generate(synthetic_config(config, traffic, seed, n_scans), device=device).batches


def bag_config(module, config: dict, config_dir: str):
    """The configuration's `frontend:` section as `module`'s BagConfig
    (module: the program's frontend.rosbag or the reference's)."""
    return module.bag_config_from_dict(config["frontend"], base_dir=config_dir)


def bag_file(config: dict, traffic: dict, config_dir: str, seed: int, cache_dir: str = CACHE_DIR) -> str:
    """The path of the cell's bag: written by the frozen bag synthesizer on
    the first call for these arguments, read from the cache after that."""
    scfg = synthetic_config(config, traffic, seed, config["n_scans"])
    text = json.dumps({"synthetic": dataclasses.asdict(scfg), "frontend": config["frontend"], "bag": config["bag"]},
                      sort_keys=True)
    args = json.loads(text)
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"bag_{key}.db3")
    sidecar = path + ".args.json"
    if os.path.exists(path) and os.path.exists(sidecar):
        with open(sidecar) as f:
            if json.load(f) == args:
                return path
    tmp = path + ".part"
    for p in (tmp, path, sidecar):
        if os.path.exists(p):
            os.remove(p)
    b = config["bag"]
    bag_synth.write_synth_bag(tmp, scfg, bag_config(rosbag, config, config_dir), odom_rate_hz=b["odom_rate_hz"],
                              cam_rate_hz=b["cam_rate_hz"], cam_size=tuple(b["cam_size"]),
                              jpeg_quality=b["jpeg_quality"])
    os.replace(tmp, path)
    with open(sidecar, "w") as f:
        json.dump(args, f, sort_keys=True)
    return path


def timed_bag_file(run, config: dict, traffic: dict, config_dir: str) -> str:
    """bag_file for the run's seed, its seconds added to run.setup_apart_s:
    a seed's first run writes the bag once, as a checkout's first run
    builds the libraries, so its synthesis is kept out of setup_s."""
    t0 = time.perf_counter()
    path = bag_file(config, traffic, config_dir, run.seed)
    run.setup_apart_s += time.perf_counter() - t0
    return path
