"""The native switch of the port: GCSLAM_NO_NATIVE=1 (the JAX package's
frontend/native.py switch) picks the Python route of load_bag, of the
synthetic generator's camera frontend and of eval.run, says so on stderr
and in runtime_manifest.json; a caller's native=True/False wins over it.
The native route itself is held to the JAX generator's in
tests/test_torch_native_route.py."""

import dataclasses
import json

import numpy as np
import pytest

from gcslam_torch.eval import run as eval_run
from gcslam_torch.frontend import bag_synth, native, rosbag, synthetic as tsyn
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.manifest import runtime_manifest
from test_torch_bag import CAM_SIZE, KIMERA, kimera_bag_configs
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture
def library_calls(monkeypatch):
    """Counts the native library's uses (every native op goes through
    native.library())."""
    calls = []
    lib = native.library

    def counting():
        calls.append(1)
        return lib()

    monkeypatch.setattr(native, "library", counting)
    monkeypatch.delenv("GCSLAM_NO_NATIVE", raising=False)
    return calls


@pytest.fixture(scope="module")
def small_bag(tmp_path_factory):
    d = tmp_path_factory.mktemp("bag")
    db, gt = str(d / "b.db3"), str(d / "b.tum")
    _, tcfg = kimera_bag_configs()
    bag_synth.write_synth_bag(db, tsyn.SyntheticConfig(n_scans=4, n_points=1024, seed=0), tcfg, gt_path=gt,
                              cam_size=CAM_SIZE)
    return db, gt


def same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in x._fields:
            np.testing.assert_array_equal(getattr(x, f).numpy(), getattr(y, f).numpy(), err_msg=f)


def test_switch_selects_the_python_route_in_load_bag(small_bag, library_calls, monkeypatch, capsys):
    _, tcfg = kimera_bag_configs()
    nat, _, _ = rosbag.load_bag(small_bag[0], config=tcfg, device="cpu")
    assert library_calls
    assert "GCSLAM_NO_NATIVE" not in capsys.readouterr().err
    py, _, _ = rosbag.load_bag(small_bag[0], config=tcfg, device="cpu", native=False)

    monkeypatch.setenv("GCSLAM_NO_NATIVE", "1")
    library_calls.clear()
    got, _, _ = rosbag.load_bag(small_bag[0], config=tcfg, device="cpu")
    assert not library_calls
    assert "GCSLAM_NO_NATIVE=1: the bag decoder takes the Python route" in capsys.readouterr().err
    same_batches(got, py)
    forced, _, _ = rosbag.load_bag(small_bag[0], config=tcfg, device="cpu", native=True)
    assert library_calls
    same_batches(forced, nat)


def test_switch_selects_the_pure_route_in_generate(library_calls, monkeypatch, capsys):
    cfg = tsyn.SyntheticConfig(n_scans=2, n_points=256, with_camera=True)
    nat = tsyn.generate(cfg, device="cpu")
    assert library_calls
    pure = tsyn.generate(cfg, device="cpu", native=False)

    monkeypatch.setenv("GCSLAM_NO_NATIVE", "1")
    library_calls.clear()
    got = tsyn.generate(cfg, device="cpu")
    assert not library_calls
    assert "the synthetic camera frontend takes the Python route" in capsys.readouterr().err
    same_batches(got.batches, pure.batches)
    same_batches(tsyn.generate(cfg, device="cpu", native=True).batches, nat.batches)
    # the camera-off generator has no native stage and says nothing
    library_calls.clear()
    capsys.readouterr()
    tsyn.generate(dataclasses.replace(cfg, with_camera=False), device="cpu")
    assert not library_calls and not capsys.readouterr().err


def test_manifest_records_the_route(monkeypatch):
    monkeypatch.delenv("GCSLAM_NO_NATIVE", raising=False)
    assert runtime_manifest(PipelineConfig())["frontend_route"] == "native"
    monkeypatch.setenv("GCSLAM_NO_NATIVE", "1")
    assert runtime_manifest(PipelineConfig())["frontend_route"] == "python"


def test_eval_run_honours_the_switch(small_bag, tmp_path, library_calls, monkeypatch, capsys):
    monkeypatch.setenv("GCSLAM_NO_NATIVE", "1")
    db, gt = small_bag
    eval_run.main(["--cpu", "--bag", db, "--config", KIMERA, "--gt", gt, "--points", "512", "--no-camera",
                   "--out", str(tmp_path / "run")])
    assert not library_calls
    assert "the bag decoder takes the Python route" in capsys.readouterr().err
    assert json.load(open(tmp_path / "run" / "runtime_manifest.json"))["frontend_route"] == "python"
