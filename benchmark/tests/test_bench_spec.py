"""BENCHMARK.json against the contract's rules, and the harness finding a
new configuration, traffic mix and per-layer metric by name alone."""

import json
import os
import shutil

import pytest

from benchmark import spec

KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def test_keys_and_names(bench):
    assert set(bench) == KEYS
    assert spec.check_names(bench) == []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(spec.ROOT, c["file"]))
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            body = json.load(f)
        assert set(c["reduced"]) <= set(body) and c["source"] == body["source"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "limits", w["name"] + ".json"))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        # each cell that reports a per-layer metric reports the metric it moves
        for w in m.get("workloads", cells):
            assert w in cells and spec._reports(e2e[m["moves"]], w)
        assert callable(spec.metric_reader(m["name"]))
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:  # setup_s, one more end-to-end metric and one per-layer metric in every cell
        cell = spec.load_cell(w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_a_new_cell_needs_only_new_files(tmp_path, bench):
    """A configuration, a traffic mix, a per-layer metric and a cell that a
    later change would add: new files and new entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    new = json.loads(json.dumps(bench))
    (root / "benchmark" / "configs" / "flagship_small.json").write_text(
        (root / "benchmark" / "configs" / "flagship.json").read_text())
    (root / "benchmark" / "traffic" / "ramp_once.json").write_text(json.dumps({"driver": "replay", "bags": 1}))
    new["configs"].append(dict(new["configs"][0], name="flagship_small", file="benchmark/configs/flagship_small.json"))
    new["workloads"].append({"name": "flagship-once", "config": "flagship_small", "traffic": "ramp_once",
                             "chips": 1, "why": "a throwaway cell"})
    new["per_layer"].append({"name": "device_kernels_per_scan.once", "unit": "kernels/scan", "better": "lower",
                             "source": "device_trace", "layer": "step", "moves": "replay_ms_per_scan",
                             "workloads": ["flagship-once"]})
    new["end_to_end"] = [dict(m, workloads=m["workloads"] + ["flagship-once"]) if "workloads" in m
                         and m["name"] == "replay_ms_per_scan" else m for m in new["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.load_cell("flagship-once", root=str(root))
    assert cell.traffic == {"driver": "replay", "bags": 1} and cell.config["n_scans"] == 50
    assert [m["name"] for m in cell.per_layer] == ["capture_s", "device_kernels_per_scan.once"]
    assert spec.check_names(new) == []


def test_the_kept_cells_come_back_by_entries_alone(bench):
    """kimera-bag, flagship-live10hz and kimera-replay, which BENCHMARK.json
    holds no longer, load from their kept files with entries added and
    nothing edited."""
    from conftest import KEPT_WORKLOADS, with_kept

    new = with_kept(bench)
    assert spec.check_names(new) == []
    for w in KEPT_WORKLOADS:
        cell = spec.load_cell(w["name"], spec=new)
        assert cell.traffic["driver"] in ("bag", "live", "replay") and len(cell.end_to_end) == 3 and cell.per_layer
