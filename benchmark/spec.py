"""BENCHMARK.json and the files it names: a cell's configuration
(configs/<config>.json), its traffic mix (traffic/<mix>.json), and the
per-layer metrics it reports, each with its reader (metrics/<family>.py,
where the family is the metric's name before the first dot)."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
from typing import List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports
    config_dir: str  # where the configuration's files lie


def load_spec(path: str = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files read."""
    spec = load_spec(os.path.join(root, "BENCHMARK.json")) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg_path = os.path.join(root, cfg["file"])
    with open(cfg_path) as f:
        config = json.load(f)
    with open(os.path.join(root, os.path.basename(BENCH_DIR), "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, config, traffic, e2e, per_layer, os.path.dirname(cfg_path))


def metric_reader(name: str):
    """metrics/<family>.py's read(ctx, name) for the per-layer metric `name`."""
    family = name.split(".", 1)[0]
    return importlib.import_module(f"benchmark.metrics.{family}").read


def check_names(spec: dict) -> List[str]:
    """What in BENCHMARK.json breaks the naming rules (empty when none)."""
    bad = []
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    bad += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    bad += [f"unit {m['unit']!r}" for m in metrics if not UNIT_RE.match(m["unit"])]
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in spec[group]]
        bad += [f"duplicate {group} name {n!r}" for n in set(seen) if seen.count(n) > 1]
    seen = [m["name"] for m in metrics]
    bad += [f"duplicate metric name {n!r}" for n in set(seen) if seen.count(n) > 1]
    return bad
