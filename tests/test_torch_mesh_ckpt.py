"""The sharded checkpoint (gcslam_torch/utils/checkpoint.py
save_state_sharded / load_state_sharded, torch.distributed.checkpoint of
DTensor views) on 4 gloo ranks spawned on the CPU, running
tests/torch_mesh_ranks.py; saved after 2 of 4 scans:

  - (run=2, hyp=2), map off, hyp_diversify: resumed on the same mesh, the
    restored blocks equal the saved ones and the continuation equals the
    uninterrupted run bit for bit (the contract tests/test_outputs.py holds
    the JAX package's orbax checkpoint to); resumed on (run=4), within 1e-8
    of it (the blocks' shapes change the rounding); the gathered state
    through the flat npz: resumed in one process within 1e-8, and read by
    the JAX package's load_state leaf for leaf;
  - (run=2, map=2), map on (MAP8), the tile-split payload: the same-mesh
    resume bit-equal; loaded onto (run=4), the gathered state equals the
    saved one to the bit (the checkpoint reshards);
  - load_state_sharded leaves the `like` it was given as it was.
"""

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.parallel import sweep as jsweep
from gcslam_tpu.utils import checkpoint as jckpt
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.parallel import mesh as mesh_mod
from gcslam_torch.parallel import sweep
from gcslam_torch.utils import checkpoint as ckpt
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_slice import np_tree

RESUME_ATOL = 1e-8  # a resume on another mesh or in one process against the uninterrupted mesh run
N_RUNS, N_SCANS, N_FIRST = 4, 4, 2
WORLDS = {"no_map4": 256, "map4": 512}  # points a scan
HYP_CFG = dict(with_map=False, hyp_diversify=True)


@pytest.fixture(scope="module")
def np_worlds():
    return {name: [[np_tree(b) for b in jgenerate(JSynth(n_scans=N_SCANS, n_points=n, seed=s)).batches]
                   for s in range(N_RUNS)] for name, n in WORLDS.items()}


@pytest.fixture(scope="module")
def results(np_worlds, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_ckpt"))
    return mesh_mod.run_ranks(ranks.checkpoints, ranks.WORLD_SIZE, "cpu", np_worlds, root, N_FIRST, timeout=600)


@pytest.mark.parametrize("name", ["hyp", "map"])
def test_a_resume_on_the_same_mesh_is_bit_equal(results, name):
    for rank in results:
        got = rank[name]
        assert len(got["saved_local"]) == len(got["resumed_local"])
        for saved, restored in zip(got["saved_local"], got["resumed_local"]):
            assert saved.dtype == restored.dtype
            np.testing.assert_array_equal(restored, saved)
        assert np.all(np.isfinite(got["pose_cont"]))
        np.testing.assert_array_equal(got["pose_resumed"], got["pose_cont"])


@pytest.mark.parametrize("name", ["hyp", "map"])
def test_loading_leaves_like_as_it_was(results, name):
    assert all(rank[name]["like_untouched"] for rank in results)


def test_a_resume_on_another_mesh_continues_the_run(results):
    got = results[0]["hyp"]
    np.testing.assert_allclose(got["pose_resumed_run4"], got["pose_cont"], rtol=0, atol=RESUME_ATOL)


def test_the_checkpoint_reshards_the_tile_split_map(results):
    got = results[0]["map"]
    assert got["saved_local"][-1].shape[0] == N_RUNS // 2  # next_global_id: this rank's 2 runs
    for saved, moved in zip(got["whole"], got["whole_from_run4"]):
        np.testing.assert_array_equal(moved, saved)
    weights = next(x for x in got["whole"] if x.shape[1:] == (ranks.MAP8["atlas_max_tiles"], ranks.MAP8["m_tile"])
                   and x.dtype == np.float32)
    assert weights.max() > 0  # the saved maps hold primitives
    np.testing.assert_allclose(got["pose_resumed_run4"], got["pose_cont"], rtol=0, atol=1e-5)


def test_the_gathered_state_resumes_through_the_npz_in_one_process(results, np_worlds):
    got = results[0]["hyp"]
    cfg = PipelineConfig(**HYP_CFG)
    like = sweep.batched_init_state(cfg, N_RUNS, device="cpu")
    states = ckpt.load_state(got["npz"], like)
    for x, y in zip(ckpt.state_leaves(states), got["whole"]):
        np.testing.assert_array_equal(x.numpy(), y)
    rest = [run[N_FIRST:] for run in ranks.to_runs(np_worlds["no_map4"], "cpu")]
    _, outs, _ = sweep.run_sweep(rest, cfg, states=states, device="cpu")
    np.testing.assert_allclose(outs.pose.numpy(), got["pose_cont"], rtol=0, atol=RESUME_ATOL)


def test_the_gathered_npz_reads_in_the_jax_package(results):
    got = results[0]["hyp"]
    theirs = jckpt.load_state(got["npz"], jsweep.batched_init_state(JConfig(**HYP_CFG), N_RUNS))
    leaves = jax.tree_util.tree_leaves(theirs)
    assert len(leaves) == len(got["whole"])
    for x, y in zip(leaves, got["whole"]):
        np.testing.assert_array_equal(np.asarray(x), y)
    np.testing.assert_array_equal(np.asarray(theirs.scan_count), np.full(N_RUNS, N_FIRST, dtype=np.int32))
