"""Replay sweeps with the map on (gcslam_torch/parallel/sweep.py), at the
map-axis configuration of tests/test_sweep.py (8 tiles, 64 primitives a
tile, 0.5 m voxels), on 2 runs of 4 scans of 512 points (at that test's
256 points no primitive is inserted in 4 scans, so its atlas weights are
all zero; at 512 the maps hold 1-5 primitives):

  - each run of the port's sweep equals its run_bag to 1e-8, and the
    Sinkhorn ran once per GN round for both runs, on B = 2 problems;
  - the port's sweep against the JAX package's sweep_step on the same
    numpy inputs, from init_state: poses within 1e-5 (the map-on tolerance
    of tests/test_torch_slice.py: the reference's point path is float32)
    and the atlas weights within 1e-5 (tests/test_sweep.py's bound for two
    of its sweeps);
  - the per-hypothesis sweep (map_gn_shared=False) runs one Sinkhorn call
    per GN round on B = 2 x K_HYP problems and equals run_bag per run to
    the float32 point path's 1e-5;
  - vmap's "performance drop" warning (an op without a batching rule
    running per sample) is an error here, and the filter is live.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.models.scan_io import stack_scan_batches as jstack
from gcslam_tpu.parallel import sweep as jsweep
from gcslam_torch import constants as C
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import sinkhorn
from gcslam_torch.parallel import sweep
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_slice import POSE_ATOL, np_tree
from test_torch_sweep import MAP8, RUN_ATOL

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

N_RUNS, N_SCANS, N_POINTS = 2, 4, 512


@pytest.fixture(scope="module")
def jruns():
    return [jgenerate(JSynth(n_scans=N_SCANS, n_points=N_POINTS, seed=s)).batches for s in range(N_RUNS)]


@pytest.fixture(scope="module")
def truns(jruns):
    return [[batch_from_numpy(np_tree(b), device="cpu") for b in run] for run in jruns]


@pytest.fixture
def sinkhorn_calls(monkeypatch):
    """Shapes of the cost matrices of every call of the plain Sinkhorn (the
    custom op's CPU kernel)."""
    calls = []
    plain = sinkhorn.sinkhorn_unbalanced_reference

    def recording(*args):
        calls.append(tuple(args[0].shape))
        return plain(*args)

    monkeypatch.setattr(sinkhorn, "sinkhorn_unbalanced_reference", recording)
    return calls


def check_runs(truns, cfg, calls, B, atol=RUN_ATOL):
    states, outs, _ = sweep.run_sweep(truns, cfg, device="cpu")
    n_calls = len(calls)
    assert n_calls == N_SCANS * cfg.map_icp_iters
    assert {c[0] for c in calls} == {B} and all(len(c) == 3 for c in calls), set(calls)
    for r, batches in enumerate(truns):
        _, single = runner.run_bag(batches, cfg, device="cpu")
        np.testing.assert_allclose(outs.pose[r].numpy(), single.pose.numpy(), rtol=0, atol=atol)
        np.testing.assert_array_equal(outs.tape.map_valid_total[r].numpy(), single.tape.map_valid_total.numpy())
    return states, outs


def test_map_sweep_equals_run_bag_and_the_jax_sweep(jruns, truns, sinkhorn_calls):
    cfg = PipelineConfig(**MAP8)
    states, outs = check_runs(truns, cfg, sinkhorn_calls, B=N_RUNS)
    assert float(outs.tape.map_valid_total[:, -1].min()) > 0

    jcfg = JConfig(**MAP8)
    jb = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                *[jstack(run) for run in jruns])
    jstates = jsweep.batched_init_state(jcfg, N_RUNS)
    jposes = []
    for k in range(N_SCANS):
        jstates, jouts, _ = jsweep.sweep_step(jstates, jax.tree_util.tree_map(lambda x: x[:, k], jb), jcfg)
        jposes.append(np.asarray(jouts.pose))
    np.testing.assert_allclose(outs.pose.numpy(), np.stack(jposes, axis=1), rtol=0, atol=POSE_ATOL)
    w, jw = states.atlas.weights.numpy(), np.asarray(jstates.atlas.weights)
    assert w.shape == jw.shape and w.shape[0] == N_RUNS
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-5)


def test_per_hypothesis_sweep_is_one_launch_per_gn_round(truns, sinkhorn_calls):
    """Each hypothesis extracts its own surfels and runs its own GN chain on
    the float32 point path, where the batched products of the sweep round
    one ulp away from run_bag's and a near-planar surfel amplifies that:
    the runs agree to 1.2e-7 m here, so within tests/test_torch_slice.py's
    POSE_ATOL, which bounds the same effect between the packages."""
    cfg = PipelineConfig(**MAP8, map_gn_shared=False)
    check_runs(truns, cfg, sinkhorn_calls, B=N_RUNS * C.K_HYP, atol=POSE_ATOL)


def test_the_performance_drop_filter_is_live():
    with pytest.raises(UserWarning, match="performance drop"):
        torch.func.vmap(lambda x: torch.histc(x, 4))(torch.ones(2, 5))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.func.vmap(lambda x: torch.histc(x, 4))(torch.ones(2, 5))
