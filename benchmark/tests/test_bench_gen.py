"""The frozen generators against the program's generators of today, bit for
bit, at a tiny size."""

import dataclasses
import sqlite3

import numpy as np
import pytest
import torch

from benchmark.gen import scans as gen
from conftest import with_kept
from benchmark.reference.plain.frontend import bag_synth as rbag_synth, rosbag as rrosbag, synthetic as rsyn
from gcslam_torch.frontend import bag_synth, rosbag, synthetic

torch.set_num_threads(2)


@pytest.mark.parametrize("traffic", [{"trajectory": "ramp", "odom_model": "additive"},
                                     {"trajectory": "circuit", "odom_model": "integrated"}])
def test_synthetic_scans(traffic):
    cfg = dict(n_scans=5, n_points=256, seed=2**31 + 3, **traffic)
    a = synthetic.generate(synthetic.SyntheticConfig(**cfg), device="cpu")
    b = rsyn.generate(rsyn.SyntheticConfig(**cfg), device="cpu")
    assert len(a.batches) == len(b.batches) == 5
    for x, y in zip(a.batches, b.batches):
        assert x._fields == y._fields and all(torch.equal(u, v) for u, v in zip(x, y))
    assert np.array_equal(a.gt_poses, b.gt_poses) and np.array_equal(a.gt_times, b.gt_times)


def _rows(path):
    with sqlite3.connect(path) as c:
        return (c.execute("select * from topics order by id").fetchall(),
                c.execute("select topic_id, timestamp, data from messages order by id").fetchall())


def test_bag_file(tmp_path):
    from benchmark import spec

    cell = spec.load_cell("kimera-bag", spec=with_kept(spec.load_spec()))
    fe = dict(cell.config["frontend"])
    scfg = dict(n_scans=4, n_points=1024, trajectory="circuit", odom_model="integrated", seed=11)
    pa, pb = str(tmp_path / "a.db3"), str(tmp_path / "b.db3")
    bag_synth.write_synth_bag(pa, synthetic.SyntheticConfig(**scfg),
                              rosbag.bag_config_from_dict(fe, base_dir=cell.config_dir), cam_size=(160, 120))
    rbag_synth.write_synth_bag(pb, rsyn.SyntheticConfig(**scfg),
                               rrosbag.bag_config_from_dict(fe, base_dir=cell.config_dir), cam_size=(160, 120))
    ta, ma = _rows(pa)
    tb, mb = _rows(pb)
    assert ta == tb and len(ma) > 40 and ma == mb


def test_the_cache_writes_once(tmp_path, monkeypatch):
    from benchmark import spec

    cell = spec.load_cell("kimera-bag", spec=with_kept(spec.load_spec()))
    cfg = dict(cell.config, n_scans=2, synthetic=dict(cell.config["synthetic"], n_points=256),
               bag=dict(cell.config["bag"], cam_size=[64, 48]))
    calls = []
    real = gen.bag_synth.write_synth_bag
    monkeypatch.setattr(gen.bag_synth, "write_synth_bag", lambda *a, **k: calls.append(1) or real(*a, **k))
    p1 = gen.bag_file(cfg, cell.traffic, cell.config_dir, 5, cache_dir=str(tmp_path))
    p2 = gen.bag_file(cfg, cell.traffic, cell.config_dir, 5, cache_dir=str(tmp_path))
    p3 = gen.bag_file(cfg, cell.traffic, cell.config_dir, 6, cache_dir=str(tmp_path))
    assert p1 == p2 != p3 and len(calls) == 2
    assert dataclasses.asdict(gen.synthetic_config(cfg, cell.traffic, 5, 2))["trajectory"] == "circuit"


def test_the_bag_synthesis_is_kept_out_of_setup(monkeypatch):
    """The seconds of bag_file (a seed's first run writes the bag) go to
    the run's setup_apart_s, which setup_s leaves out."""
    import time

    from benchmark import harness
    from benchmark.gen import scans

    class Run:
        seed, setup_apart_s, t_start, window_start = 7, 0.0, 0.0, 5.0

    monkeypatch.setattr(scans, "bag_file", lambda *a: (time.sleep(0.2), "bag.db3")[1])
    assert scans.timed_bag_file(Run, {}, {}, "") == "bag.db3" and Run.setup_apart_s >= 0.2
    assert harness.setup_s(Run) == 5.0 - Run.setup_apart_s
