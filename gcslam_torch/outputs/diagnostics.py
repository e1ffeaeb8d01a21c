"""Diagnostics persistence: the per-scan ScanTape (stacked over scans by
runner.run_bag) to npz, and the map-maintenance event log (counterpart of
the JAX package's outputs/diagnostics.py)."""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from gcslam_torch.ops.certs import decode_triggers


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tape_to_dict(tape) -> Dict[str, np.ndarray]:
    return {f: _np(getattr(tape, f)) for f in tape._fields}


def save_diagnostics_npz(path: str, tape, poses=None, stamps=None) -> None:
    data = tape_to_dict(tape)
    if poses is not None:
        data["poses"] = _np(poses)
    if stamps is not None:
        data["stamps"] = _np(stamps)
    np.savez_compressed(path, **data)


def trigger_history(tape) -> list:
    """Decode the per-scan trigger bitmasks into name lists."""
    return [decode_triggers(int(m)) for m in _np(tape.cert_triggers)]


def summary_json(tape) -> str:
    d = tape_to_dict(tape)
    out = {}
    for k, v in d.items():
        if v.dtype.kind == "f":
            out[k] = {"mean": float(np.mean(v)), "last": float(v[-1]), "max": float(np.max(v))}
    out["triggers_seen"] = sorted(set(t for names in trigger_history(tape) for t in names))
    return json.dumps(out, indent=2, sort_keys=True)


def save_map_event_log(path: str, tape) -> None:
    """Map maintenance event log, one JSON line per scan: insertion /
    eviction / cull / merge masses and counts, OT transport health and the
    scan-IO coverage that fed the update, then one line per inserted
    primitive (id, tile, position, weight)."""
    d = tape_to_dict(tape)
    n = len(np.asarray(d["timestamp"]).reshape(-1))
    keys = [
        ("t", "timestamp"),
        ("fused_mass", "map_fused_mass"),
        ("insert_mass", "map_insert_mass"),
        ("evicted_mass", "map_evicted_mass"),
        ("n_culled", "map_n_culled"),
        ("n_merged", "map_n_merged"),
        ("valid_total", "map_valid_total"),
        ("ot_transport_mass", "ot_transport_mass"),
        ("ot_marginal_defect_a", "ot_marginal_defect_a"),
        ("n_points_valid", "io_n_points_valid"),
        ("n_imu_valid", "io_n_imu_valid"),
        ("imu_coverage", "io_imu_coverage"),
        ("loop_weight", "io_loop_weight"),
    ]
    ins_ids = d.get("map_ins_ids")
    have_inserts = ins_ids is not None and ins_ids.size > 0
    with open(path, "w") as f:
        for k in range(n):
            row = {"scan": k}
            for name, field in keys:
                if field in d:
                    row[name] = float(np.asarray(d[field]).reshape(-1)[k])
            f.write(json.dumps(row) + "\n")
            if have_inserts:
                ids_k = ins_ids[k]
                for j in np.nonzero(ids_k >= 0)[0]:
                    f.write(json.dumps({
                        "scan": k,
                        "event": "insert",
                        "id": int(ids_k[j]),
                        "tile_id": int(d["map_ins_tiles"][k][j]),
                        "mu_world": [round(float(x), 4) for x in d["map_ins_mu"][k][j]],
                        "weight": round(float(d["map_ins_w"][k][j]), 6),
                        "t": float(np.asarray(d["timestamp"]).reshape(-1)[k]),
                    }) + "\n")
