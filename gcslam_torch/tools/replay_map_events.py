"""Replay the per-insertion map event log — the consumer side of the
reference's append-only insertion event log (spec 5.7.7; events built at
backend/pipeline.py:1393-1410 "for post-run replay").

Reads `map_events.jsonl` (written by eval.run via
outputs/diagnostics.save_map_event_log: per-scan aggregate lines + one
`event: insert` line per inserted primitive) and reconstructs map growth
primitive-by-primitive:

  - integrity: insertion ids strictly increasing (global id counter), every
    event carries a tile id and finite position/weight;
  - timeline: per-scan insert counts, cumulative primitive count, first/last
    insertion scan per tile;
  - optional snapshot: positions+weights of every primitive inserted up to
    --at-scan N, written as an npz point snapshot (the replayed map state's
    insertion skeleton at scan N).

Usage:
  python -m gcslam_torch.tools.replay_map_events results/run/map_events.jsonl
      [--at-scan N --snapshot out.npz] [--json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def replay_map_events(path: str, at_scan: int | None = None) -> dict:
    inserts = []
    aggregates = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == "insert":
                inserts.append(rec)
            else:
                aggregates.append(rec)

    out: dict = {"path": path, "n_scans": len(aggregates), "n_inserts": len(inserts)}
    if not inserts:
        out["integrity"] = {"ids_strictly_increasing": True, "all_finite": True}
        return out

    ids = np.array([e["id"] for e in inserts])
    scans = np.array([e["scan"] for e in inserts])
    mus = np.array([e["mu_world"] for e in inserts], dtype=np.float64)
    ws = np.array([e["weight"] for e in inserts], dtype=np.float64)
    tiles = [e["tile_id"] for e in inserts]

    out["integrity"] = {
        "ids_strictly_increasing": bool(np.all(np.diff(ids) > 0)),
        "scans_monotone": bool(np.all(np.diff(scans) >= 0)),
        "all_finite": bool(np.all(np.isfinite(mus)) and np.all(np.isfinite(ws))),
        "weights_nonnegative": bool(np.all(ws >= 0)),
    }

    per_scan = {}
    for s in scans:
        per_scan[int(s)] = per_scan.get(int(s), 0) + 1
    per_tile: dict = {}
    for e in inserts:
        t = per_tile.setdefault(e["tile_id"], {"n": 0, "first_scan": e["scan"]})
        t["n"] += 1
        t["last_scan"] = e["scan"]
    out["timeline"] = {
        "inserts_per_scan_mean": round(len(inserts) / max(len(aggregates), 1), 2),
        "inserts_per_scan_max": int(max(per_scan.values())),
        "n_tiles_touched": len(per_tile),
        "cumulative_by_scan_tail": {
            int(s): int(np.sum(scans <= s))
            for s in sorted(set(scans.tolist()))[-3:]
        },
    }

    if at_scan is not None:
        sel = scans <= at_scan
        out["snapshot"] = {
            "at_scan": at_scan,
            "n_primitives": int(sel.sum()),
            "positions": mus[sel],
            "weights": ws[sel],
            "ids": ids[sel],
            "tile_ids": [t for t, m in zip(tiles, sel) if m],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("events_jsonl")
    ap.add_argument("--at-scan", type=int, default=None)
    ap.add_argument("--snapshot", default=None, metavar="OUT_NPZ")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rep = replay_map_events(args.events_jsonl, args.at_scan)
    snap = rep.pop("snapshot", None)
    if snap is not None and args.snapshot:
        np.savez_compressed(
            args.snapshot, positions=snap["positions"], weights=snap["weights"],
            ids=snap["ids"],
        )
        rep["snapshot_file"] = args.snapshot
        rep["snapshot_n"] = snap["n_primitives"]
    elif snap is not None:
        rep["snapshot_n"] = snap["n_primitives"]
    print(json.dumps(rep, indent=2 if args.json else None))
    return 0 if all(rep["integrity"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
