"""Live visualization during a streaming run (counterpart of the JAX
package's outputs/live_view.py, the reference's live Rerun mode,
backend/rerun_visualizer.py:34).

Two backends, picked at construction:

  rerun  — when the `rerun` SDK imports: a recording (`spawn=True` pops the
           viewer, else `live.rrd` in `out_dir`) with `world/trajectory`,
           `world/lidar` and `world/map/points` logged as the run goes, the
           entity layout of outputs/rerun_export.py;
  file   — without the SDK: an append-only directory, `live.jsonl` (one line
           per logged scan: pose, stamp, map size, points file; one line per
           map snapshot) plus point and map-snapshot npz files, a tail-able
           stream any viewer can poll (the contract of the reference's live
           /gc/map and /gc/state topics, map_publisher.py:90,
           backend_node.py:2212-2293).

The viewer reads only what the runner already holds on the host: the pose
it brings back each scan, the scan's points (host copies, every
`points_every` scans) and a map snapshot every `map_every` scans. It never
writes into the run's tensors, so the poses are the same with it on or off.
"""

from __future__ import annotations

import json
import os

import numpy as np


class LiveViewer:
    def __init__(self, out_dir: str, spawn: bool = False, points_every: int = 10, map_every: int = 20,
                 max_points: int = 2048):
        self.points_every = max(1, points_every)
        self.map_every = max(1, map_every)
        self.max_points = max_points
        self.out_dir = out_dir
        self._traj: list = []
        try:
            import rerun as rr  # type: ignore

            self.rr = rr
            self.backend = "rerun"
            rr.init("gcslam_torch", spawn=spawn)
            if not spawn:
                os.makedirs(out_dir, exist_ok=True)
                rr.save(os.path.join(out_dir, "live.rrd"))
        except ImportError:
            self.rr = None
            self.backend = "file"
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "live.jsonl"), "w")

    def log_scan(self, i: int, stamp: float, pose6: np.ndarray, points: np.ndarray | None = None,
                 weights: np.ndarray | None = None, map_valid_total: float = 0.0) -> None:
        """One scan: its pose (always) and its weighted points (every
        `points_every` scans, thinned to at most about `max_points`)."""
        pose6 = np.asarray(pose6, dtype=np.float64)
        self._traj.append(pose6[:3].copy())
        pts = None
        if points is not None and i % self.points_every == 0:
            pts = np.asarray(points, dtype=np.float32)
            if weights is not None:
                pts = pts[np.asarray(weights) > 0]
            if len(pts) > self.max_points:
                pts = pts[:: max(1, len(pts) // self.max_points)]
        if self.backend == "rerun":
            rr = self.rr
            rr.set_time_seconds("scan_time", float(stamp))
            rr.log("world/trajectory", rr.LineStrips3D([np.asarray(self._traj, dtype=np.float32)]))
            if pts is not None:
                rr.log("world/lidar", rr.Points3D(pts))
            return
        rec = {"scan": int(i), "stamp": float(stamp), "pose": [round(float(v), 6) for v in pose6],
               "map_valid_total": float(map_valid_total)}
        if pts is not None:
            name = f"points_{i:06d}.npz"
            np.savez_compressed(os.path.join(self.out_dir, name), points=pts)
            rec["points_file"] = name
        self._write(rec)

    def maybe_log_map(self, i: int, atlas) -> None:
        """A splat snapshot of the map every `map_every` scans."""
        if i % self.map_every != 0:
            return
        from gcslam_torch.outputs.splat_export import save_splat_export

        name = f"live_map_{i:06d}.npz"
        n = save_splat_export(os.path.join(self.out_dir, name), atlas)
        if self.backend == "rerun":
            d = np.load(os.path.join(self.out_dir, name))
            self.rr.log("world/map/points",
                        self.rr.Points3D(d["mu_world"], colors=(d["colors"] * 255).astype(np.uint8)))
        else:
            self._write({"scan": int(i), "map_file": name, "n_splats": int(n)})

    def _write(self, rec: dict) -> None:
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self.backend == "file":
            self._jsonl.close()
