"""The port's live view (outputs/live_view.LiveViewer) and the runners that
drive it: the file backend (no rerun SDK here or on the GPU hosts) through
run_stream, mirroring tests/test_outputs.py::test_live_view_file_backend;
the same log calls written byte for byte as the JAX package's viewer
writes them; and run_stream / run_chunked poses bit-equal with the viewer
on and off (the viewer reads host copies only)."""

import json

import numpy as np
import pytest
import torch

from gcslam_tpu.outputs.live_view import LiveViewer as JLiveViewer
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.outputs.live_view import LiveViewer
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = dict(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)


@pytest.fixture(scope="module")
def world():
    return generate(SyntheticConfig(n_scans=7, n_points=256), device="cpu")


def read(path):
    return [json.loads(line) for line in open(path)]


def test_live_view_file_backend(tmp_path, world):
    cfg = PipelineConfig(**CFG)
    d = str(tmp_path / "live")
    viewer = LiveViewer(d, points_every=3, map_every=5)
    assert viewer.backend == "file"  # no rerun SDK
    _, out = runner.run_stream(world.batches, cfg, live_viewer=viewer, device="cpu")
    lines = read(f"{d}/live.jsonl")
    assert [e["scan"] for e in lines if "pose" in e] == list(range(7))
    pts = [e for e in lines if "points_file" in e]
    assert [e["scan"] for e in pts] == [0, 3, 6]
    arr = np.load(f"{d}/{pts[0]['points_file']}")["points"]
    assert arr.ndim == 2 and arr.shape[1] == 3
    maps = [e for e in lines if "map_file" in e]
    assert [e["scan"] for e in maps] == [0, 5]
    assert maps[-1]["n_splats"] >= 0
    assert np.load(f"{d}/{maps[-1]['map_file']}")["mu_world"].shape[0] == maps[-1]["n_splats"]
    poses = np.array([e["pose"] for e in lines if "pose" in e])
    np.testing.assert_array_equal(poses, np.round(out.pose.numpy(), 6))
    # the viewer reads host copies: the run's poses are bit-equal without it
    _, plain = runner.run_stream(world.batches, cfg, device="cpu")
    _, bag = runner.run_bag(world.batches, cfg, device="cpu")
    assert torch.equal(out.pose, plain.pose) and torch.equal(out.pose, bag.pose)


def test_run_chunked_logs_every_scan(tmp_path, world):
    """The JAX package's run_chunked takes no viewer; the port's logs every
    scan, the remainder after the last full window too."""
    cfg = PipelineConfig(**CFG)
    d = str(tmp_path / "live")
    _, out = runner.run_chunked(world.batches, cfg, chunk=3, live_viewer=LiveViewer(d, map_every=3), device="cpu")
    lines = read(f"{d}/live.jsonl")
    assert [e["scan"] for e in lines if "pose" in e] == list(range(7))
    assert [e["scan"] for e in lines if "map_file" in e] == [0, 3, 6]
    _, bag = runner.run_bag(world.batches, cfg, device="cpu")
    assert torch.equal(out.pose, bag.pose)


def test_log_scan_writes_what_the_jax_viewer_writes(tmp_path):
    rng = np.random.default_rng(0)
    got, ref = tmp_path / "torch", tmp_path / "jax"
    viewers = (LiveViewer(str(got), points_every=2, max_points=100),
               JLiveViewer(str(ref), points_every=2, max_points=100))
    for i in range(5):
        pose = rng.normal(0, 1, 6)
        points, weights = rng.normal(0, 5, (1000, 3)), (rng.uniform(size=1000) > 0.3).astype(np.float32)
        for v in viewers:
            v.log_scan(i, 1.7e9 + 0.1 * i, pose, points=points, weights=weights, map_valid_total=3.0 * i)
    for v in viewers:
        v.close()
    assert (got / "live.jsonl").read_text() == (ref / "live.jsonl").read_text()
    for e in read(got / "live.jsonl"):
        if "points_file" in e:
            np.testing.assert_array_equal(np.load(got / e["points_file"])["points"],
                                          np.load(ref / e["points_file"])["points"])
