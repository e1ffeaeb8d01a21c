"""Replay sweeps (gcslam_torch/parallel/sweep.py) on the CPU, with the
map off and the Sinkhorn's vmap rule:

  - a sweep run r equals run_bag on seed r (the batched ops round like
    the single-run ones to ~1e-15: atol 1e-8, as tests/test_sweep.py holds
    the JAX sweep to its single run);
  - the port's sweep_step against the JAX package's sweep_step, called
    unsharded on the same numpy inputs: poses, pose_mean and pose_spread
    within 1e-9, the with_map=False tolerance of tests/test_torch_runner.py
    (the packages agree there to ~1e-12);
  - the custom op's vmap rule folds every vmapped dim into one call of the
    plain loop on all problems. The plain loop's batched matrix products
    round differently from its single-problem ones (~5e-17 on these
    inputs), so a vmapped call equals the folded call bit for bit and each
    per-problem call to 1e-15 (on the card the kernel is per-problem
    exact: tests/test_torch_cuda.py);
  - a run does not depend on the others: run 0 beside them in another
    order is bit-equal, with the map off and on;
  - no op of sweep_step takes vmap's per-sample path (its "performance
    drop" warning is an error in this module);
  - the JAX package's batched initial state carries over, and a sweep
    state round-trips through utils/checkpoint with its run axis.
The map-on sweeps are in tests/test_torch_sweep_map.py.
"""

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.models.scan_io import stack_scan_batches as jstack
from gcslam_tpu.parallel import sweep as jsweep
from gcslam_torch import constants as C
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner, scan_step as tstep
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import sinkhorn
from gcslam_torch.parallel import sweep
from gcslam_torch.utils import checkpoint as tckpt
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_slice import np_tree

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

RUN_ATOL = 1e-8  # sweep run r against run_bag on seed r
NO_MAP_POSE_ATOL = 1e-9  # the port against the JAX package, with_map=False
ARGS = (0.1, 0.5, 0.5, 50)  # epsilon, tau_a, tau_b, n_iters
# tests/test_sweep.py's map axis (8 tiles, 64 primitives a tile, 0.5 m voxels)
MAP8 = dict(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)


def port_runs(n_runs, n_scans, n_points=256):
    return [generate(SyntheticConfig(n_scans=n_scans, n_points=n_points, seed=s), device="cpu").batches
            for s in range(n_runs)]


@pytest.mark.parametrize("diversify", [False, True], ids=["equal_hyps", "hyp_diversify"])
def test_sweep_runs_equal_run_bag(diversify):
    cfg = PipelineConfig(with_map=False, hyp_diversify=diversify)
    runs = port_runs(3, 6)
    _, outs, aggs = sweep.run_sweep(runs, cfg, device="cpu")
    assert outs.pose.shape == (3, 6, 6)
    assert (outs.pose[0] - outs.pose[1]).abs().max() > 1e-4  # the seeds differ
    for r, batches in enumerate(runs):
        _, single = runner.run_bag(batches, cfg, device="cpu")
        np.testing.assert_allclose(outs.pose[r].numpy(), single.pose.numpy(), rtol=0, atol=RUN_ATOL)
        np.testing.assert_array_equal(outs.stamp[r].numpy(), single.stamp.numpy())
    last = outs.pose[:, -1]
    torch.testing.assert_close(aggs[-1]["pose_mean"], last.mean(0), rtol=0, atol=0)
    assert float(aggs[-1]["pose_spread"]) > 0


def test_sweep_step_matches_the_jax_sweep_step():
    n_runs, n_scans = 3, 6
    jcfg, cfg = JConfig(with_map=False), PipelineConfig(with_map=False)
    packs = [jstack(jgenerate(JSynth(n_scans=n_scans, n_points=256, seed=s)).batches) for s in range(n_runs)]
    jb = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *packs)
    jstates = jsweep.batched_init_state(jcfg, n_runs)
    states = sweep.batched_init_state(cfg, n_runs, device="cpu")
    for k in range(n_scans):
        bk = jax.tree_util.tree_map(lambda x: x[:, k], jb)
        jstates, jouts, jagg = jsweep.sweep_step(jstates, bk, jcfg)
        states, outs, agg = sweep.sweep_step(states, batch_from_numpy(bk, device="cpu"), cfg)
        np.testing.assert_allclose(outs.pose.numpy(), np.asarray(jouts.pose), rtol=0, atol=NO_MAP_POSE_ATOL)
        np.testing.assert_allclose(agg["pose_mean"].numpy(), np.asarray(jagg["pose_mean"]), rtol=0,
                                   atol=NO_MAP_POSE_ATOL)
        np.testing.assert_allclose(float(agg["pose_spread"]), float(jagg["pose_spread"]), rtol=0,
                                   atol=NO_MAP_POSE_ATOL)
    assert float(agg["pose_spread"]) > 1e-4


@pytest.mark.parametrize("with_map", [False, True], ids=["no_map", "map"])
def test_a_run_does_not_depend_on_the_other_runs(with_map):
    """Run 0 beside the other runs in another order is bit-equal: the
    shapes are the same, so batching rounds alike, and any leak from one
    run into another would show."""
    cfg = PipelineConfig(**MAP8) if with_map else PipelineConfig(with_map=False)
    runs = port_runs(3, 4, n_points=512)
    _, first, _ = sweep.run_sweep(runs, cfg, device="cpu")
    _, second, _ = sweep.run_sweep([runs[0], runs[2], runs[1]], cfg, device="cpu")
    assert torch.equal(first.pose[0], second.pose[0])
    assert torch.equal(first.pose[1], second.pose[2]) and not torch.equal(first.pose[1], first.pose[2])


@pytest.mark.parametrize("lead", [(3,), (2, C.K_HYP)], ids=["runs", "runs_x_hyps"])
@pytest.mark.parametrize("N,K", [(1024, 8), (200, 32)])
def test_vmapped_sinkhorn_is_one_call_of_all_problems(monkeypatch, lead, N, K):
    rng = np.random.default_rng(N + K)
    Cm = torch.as_tensor(rng.uniform(0.0, 3.0, lead + (N, K)))
    a = torch.as_tensor(rng.uniform(0.1, 1.0, lead + (N,)))
    a = a / a.sum(-1, keepdim=True)
    b = torch.full((K,), 1.0 / K, dtype=torch.float64)  # unbatched, as the association's column masses
    calls = []
    plain = sinkhorn.sinkhorn_unbalanced_reference

    def recording(*args):
        calls.append(tuple(args[0].shape))
        return plain(*args)

    monkeypatch.setattr(sinkhorn, "sinkhorn_unbalanced_reference", recording)
    f = lambda c, x: sinkhorn.sinkhorn_unbalanced(c, x, b, *ARGS)  # noqa: E731
    for _ in lead[1:]:
        f = torch.func.vmap(f)
    out = torch.func.vmap(f)(Cm, a)
    B = int(np.prod(lead))
    assert calls == [(B, N, K)]
    monkeypatch.setattr(sinkhorn, "sinkhorn_unbalanced_reference", plain)
    folded = plain(Cm.reshape(B, N, K), a.reshape(B, N), b.expand(B, K), *ARGS).reshape(Cm.shape)
    assert torch.equal(out, folded)
    per = torch.stack([plain(c, x, b, *ARGS) for c, x in zip(Cm.reshape(B, N, K), a.reshape(B, N))])
    torch.testing.assert_close(out, per.reshape(Cm.shape), rtol=0, atol=1e-15)
    # the problem dims of one call fold the same way as the vmapped dims
    assert torch.equal(torch.func.vmap(lambda c, x: sinkhorn.sinkhorn_unbalanced(c, x, b, *ARGS))(
        Cm.reshape(B, N, K), a.reshape(B, N)), folded.reshape(B, N, K))


def test_jax_batched_state_carries_over_and_checkpoints_round_trip(tmp_path):
    n_runs = 3
    cfg = PipelineConfig(with_map=False)
    mine = sweep.batched_init_state(cfg, n_runs, device="cpu")
    theirs = tstep.state_from_numpy(np_tree(jsweep.batched_init_state(JConfig(with_map=False), n_runs)),
                                    device="cpu")
    for x, y in zip(tckpt.state_leaves(mine), tckpt.state_leaves(theirs)):
        assert x.shape[0] == n_runs and x.dtype == y.dtype and torch.equal(x, y)

    runs = port_runs(n_runs, 3)
    states, _, _ = sweep.run_sweep([r[:2] for r in runs], cfg, device="cpu")
    tckpt.save_state(str(tmp_path / "sweep.npz"), states)
    resumed = tckpt.load_state(str(tmp_path / "sweep.npz"), mine)
    for x, y in zip(tckpt.state_leaves(resumed), tckpt.state_leaves(states)):
        assert torch.equal(x, y)
    step = sweep.stack_runs([r[2] for r in runs], device="cpu")
    _, cont, _ = sweep.sweep_step(states, step, cfg)
    _, res, _ = sweep.sweep_step(resumed, step, cfg)
    assert torch.equal(cont.pose, res.pose)
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.load_state(str(tmp_path / "sweep.npz"), sweep.batched_init_state(cfg, n_runs + 1, device="cpu"))
