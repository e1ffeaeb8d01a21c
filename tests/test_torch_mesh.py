"""The sweep over a device mesh (gcslam_torch/parallel/mesh.py and the mesh
path of parallel/sweep.py), on 4 gloo ranks spawned on the CPU, one torch
thread each. The ranks run tests/torch_mesh_ranks.py (no JAX); this module
holds them to the single-process sweep and to the JAX package's sharded
sweep on its 8-device CPU mesh, on the same numpy inputs:

  - run axis, (run=4) at R = 8, map off: bit-equal to the single-process
    run_sweep of each rank's block of 2 runs (the same shapes), within
    1e-8 of the single-process sweep of all 8 (the batch size changes the
    rounding, ~3e-16), within 1e-9 of the JAX sweep_step on make_mesh()
    over 8 devices (tests/test_torch_sweep.py's map-off tolerance); the
    aggregates are those of the gathered poses, to the bit, and within
    1e-8 of the unsharded ones;
  - (run=2, hyp=2) with hyp_diversify=True, map off: bit-equal to the
    blocks, within 1e-8 of the 1-D (run=4) mesh (as tests/test_sweep.py
    holds the JAX 2-D mesh to its 1-D one), within 1e-9 of the JAX
    sweep_step on make_mesh_2d(2, 2); and with the per-hypothesis map
    branch (map_gn_shared=False) on 2 runs: bit-equal to the blocks,
    every Sinkhorn call on the rank's 1 run x 2 hypotheses;
  - (run=2, map=2) at MAP8 on tests/test_torch_sweep_map.py's 2 runs: the
    atlas payload split in tile blocks, the tile table whole; bit-equal to
    the blocks, poses and atlas weights within 1e-5 of the single-process
    sweep and of the JAX sweep_step on make_mesh_map(2, 2) (the float32
    point path's tolerance, tests/test_torch_sweep_map.py);
  - every rank ends with the same gathered outputs, and each family makes
    the collectives its design says, by axis;
  - the guards: a hypothesis or tile axis that does not divide, a hung
    rank, a failing rank, and CUDA ranks without cards all raise;
  - the dry run (parallel/dryrun, dryrun_multichip's counterpart) on 2
    gloo ranks through its CLI.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.models.scan_io import stack_scan_batches as jstack
from gcslam_tpu.parallel import sweep as jsweep
from gcslam_torch import constants as C
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import collectives
from gcslam_torch.parallel import dryrun
from gcslam_torch.parallel import mesh as mesh_mod
from gcslam_torch.parallel import sweep
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_slice import np_tree

WHOLE_ATOL = 1e-8  # a mesh run against the single-process sweep of all runs, and against the 1-D mesh
JAX_NO_MAP_ATOL = 1e-9  # tests/test_torch_sweep.py
MAP_ATOL = 1e-5  # poses and atlas weights with the map on, tests/test_torch_sweep_map.py
# world: (runs, scans, points)
# map2 is tests/test_torch_sweep_map.py's world; at 4 runs the packages'
# float32 point paths part by 6e-5 in one atlas weight of seed 2, unsharded
WORLDS = {"no_map8": (8, 6, 256), "no_map4": (4, 4, 256), "map2": (2, 4, 512)}
MAP_TILES = ranks.MAP8["atlas_max_tiles"]


def jax_world(name):
    n_runs, n_scans, n_points = WORLDS[name]
    return [jgenerate(JSynth(n_scans=n_scans, n_points=n_points, seed=s)).batches for s in range(n_runs)]


@pytest.fixture(scope="module")
def worlds():
    return {name: jax_world(name) for name in WORLDS}


@pytest.fixture(scope="module")
def np_worlds(worlds):
    return {name: [[np_tree(b) for b in run] for run in w] for name, w in worlds.items()}


@pytest.fixture(scope="module")
def results(np_worlds):
    """Every family on 4 gloo ranks, in one launch."""
    return mesh_mod.run_ranks(ranks.families, ranks.WORLD_SIZE, "cpu", np_worlds, timeout=600)


def single(np_worlds, family, block=None):
    """The single-process sweep of the family's world, whole or in blocks
    of `block` runs: (R, T, 6) poses and the aggregates of the whole."""
    world, _, over = ranks.FAMILIES[family]
    runs = ranks.to_runs(np_worlds[world], "cpu")
    cfg = PipelineConfig(**over)
    if block is None:
        states, outs, aggs = sweep.run_sweep(runs, cfg, device="cpu")
        return outs, aggs, states
    return np.concatenate([sweep.run_sweep(runs[i:i + block], cfg, device="cpu")[1].pose.numpy()
                           for i in range(0, len(runs), block)])


def jax_mesh_sweep(worlds, world, jmesh, jcfg):
    """The JAX package's sharded sweep: (R, T, 6) poses and the final state."""
    packs = [jstack(b) for b in worlds[world]]
    jb = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *packs)
    states = jsweep.shard_states(jsweep.batched_init_state(jcfg, len(packs)), jmesh)
    poses = []
    for k in range(WORLDS[world][1]):
        bk = jsweep.shard_batches(jax.tree_util.tree_map(lambda x: x[:, k], jb), jmesh)
        states, outs, _ = jsweep.sweep_step(states, bk, jcfg)
        poses.append(np.asarray(outs.pose))
    return np.stack(poses, axis=1), states


def block_of(family):
    spec = ranks.FAMILIES[family][1]
    return WORLDS[ranks.FAMILIES[family][0]][0] // spec[1]


@pytest.mark.parametrize("family", list(ranks.FAMILIES))
def test_a_family_is_bit_equal_to_the_single_process_sweep_of_its_blocks(results, np_worlds, family):
    """Each rank's block of runs, at the same shapes, gives what the
    single-process sweep of that block gives, to the bit: the hyp and map
    axes change nothing but where the work is done."""
    got = results[0][family]["pose"]
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, single(np_worlds, family, block_of(family)))


@pytest.mark.parametrize("family", list(ranks.FAMILIES))
def test_every_rank_gathers_the_same_outputs(results, family):
    for r in range(1, ranks.WORLD_SIZE):
        for key in ("pose", "valid_total", "pose_mean", "pose_spread", "hyp_weights", "weights"):
            if results[0][family][key] is not None:
                np.testing.assert_array_equal(results[r][family][key], results[0][family][key], err_msg=key)


def test_run_axis_matches_the_single_process_sweep_and_its_aggregates(results, np_worlds):
    got = results[0]["run"]
    outs, aggs, _ = single(np_worlds, "run")
    np.testing.assert_allclose(got["pose"], outs.pose.numpy(), rtol=0, atol=WHOLE_ATOL)
    assert np.abs(got["pose"][0] - got["pose"][1]).max() > 1e-4  # the seeds differ
    # the aggregates are those of the gathered poses, reduced as the unsharded step reduces them
    for k in range(got["pose"].shape[1]):
        poses = torch.as_tensor(got["pose"][:, k])
        mean = poses.mean(0)
        assert torch.equal(torch.as_tensor(got["pose_mean"][k]), mean)
        assert torch.equal(torch.as_tensor(got["pose_spread"][k]),
                           torch.linalg.vector_norm(poses[:, :3] - mean[None, :3], dim=-1).amax())
    np.testing.assert_allclose(got["pose_mean"], torch.stack([a["pose_mean"] for a in aggs]).numpy(), rtol=0,
                               atol=WHOLE_ATOL)
    np.testing.assert_allclose(got["pose_spread"], torch.stack([a["pose_spread"] for a in aggs]).numpy(), rtol=0,
                               atol=WHOLE_ATOL)


def test_run_axis_matches_the_jax_sweep_on_its_8_device_mesh(results, worlds):
    assert len(jax.devices()) == 8
    jposes, _ = jax_mesh_sweep(worlds, "no_map8", jsweep.make_mesh(), JConfig(with_map=False))
    np.testing.assert_allclose(results[0]["run"]["pose"], jposes, rtol=0, atol=JAX_NO_MAP_ATOL)


def test_hyp_axis_matches_the_1d_mesh_and_the_jax_2d_mesh(results, worlds):
    got = results[0]["hyp"]
    np.testing.assert_allclose(got["pose"], results[0]["hyp_1d"]["pose"], rtol=0, atol=WHOLE_ATOL)
    np.testing.assert_allclose(got["hyp_weights"], results[0]["hyp_1d"]["hyp_weights"], rtol=0, atol=WHOLE_ATOL)
    assert np.abs(got["hyp_weights"] - 1.0 / C.K_HYP).max() > 1e-6  # the weights moved
    jposes, jstates = jax_mesh_sweep(worlds, "no_map4", jsweep.make_mesh_2d(2, 2),
                                     JConfig(with_map=False, hyp_diversify=True))
    np.testing.assert_allclose(got["pose"], jposes, rtol=0, atol=JAX_NO_MAP_ATOL)
    np.testing.assert_allclose(got["hyp_weights"], np.asarray(jstates.hyp_weights), rtol=0, atol=JAX_NO_MAP_ATOL)


def test_hyp_axis_splits_the_per_hypothesis_sinkhorn_batch(results, np_worlds):
    """Per hypothesis (map_gn_shared=False) each rank's Sinkhorn batch is
    its 1 run x 2 hypotheses, once per GN round; against the
    single-process sweep within the map-on tolerance."""
    got = results[0]["hyp_map"]
    cfg = PipelineConfig(**ranks.FAMILIES["hyp_map"][2])
    n_scans = WORLDS["map2"][1]
    assert len(got["sinkhorn_calls"]) == cfg.map_icp_iters * n_scans
    assert {c[0] for c in got["sinkhorn_calls"]} == {C.K_HYP // 2}
    assert got["local_shapes"]["beliefs_L"][:2] == (1, C.K_HYP // 2)
    outs, _, _ = single(np_worlds, "hyp_map")
    np.testing.assert_allclose(got["pose"], outs.pose.numpy(), rtol=0, atol=MAP_ATOL)


def test_map_axis_matches_the_single_process_sweep_and_the_jax_map_mesh(results, np_worlds, worlds):
    got = results[0]["map"]
    assert got["local_shapes"]["atlas_weights"] == (1, MAP_TILES // 2, ranks.MAP8["m_tile"])
    assert got["local_shapes"]["tile_ids"] == (1, MAP_TILES)  # the table stays whole
    assert got["weights"].max() > 0  # the maps hold primitives
    outs, _, states = single(np_worlds, "map")
    np.testing.assert_allclose(got["pose"], outs.pose.numpy(), rtol=0, atol=MAP_ATOL)
    np.testing.assert_allclose(got["weights"], states.atlas.weights.numpy(), rtol=0, atol=MAP_ATOL)
    np.testing.assert_array_equal(got["valid_total"], outs.tape.map_valid_total.numpy())
    jposes, jstates = jax_mesh_sweep(worlds, "map2", jsweep.make_mesh_map(2, 2), JConfig(**ranks.MAP8))
    np.testing.assert_allclose(got["pose"], jposes, rtol=0, atol=MAP_ATOL)
    np.testing.assert_allclose(got["weights"], np.asarray(jstates.atlas.weights), rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("family", ["hyp_map", "map"])
def test_gather_atlas_gives_each_rank_whole_maps_of_its_runs(results, family):
    """gather_atlas (the input of render_atlas, splat_export and the map
    stream) equals the rank's runs of the whole gathered state, field for
    field; on the hyp mesh the atlas was whole all along."""
    for rank in results:
        got = rank[family]
        lo, hi = got["run_block"]
        assert len(got["rank_atlas"]) == len(ranks.AtlasState._fields)
        weights = got["rank_atlas"][ranks.AtlasState._fields.index("weights")]
        np.testing.assert_array_equal(weights, got["weights"][lo:hi])
        assert weights.shape[1] == MAP_TILES


@pytest.mark.parametrize("family,per_scan", [
    ("run", {"run": 1}), ("hyp", {"run": 1, "hyp": 1}), ("hyp_map", {"run": 1, "hyp": 2}),
    ("map", {"run": 1, "map": 4}),
])
def test_collectives_per_scan(results, family, per_scan):
    """run: the aggregates' pose gather; hyp: the hypotheses' outputs (and
    hypothesis 0's belief where the map reads it); map: the reads of the
    inflation, the view and the slab, and valid_total. Plus one gather of
    the outputs at the end of run_sweep."""
    n_scans = WORLDS[ranks.FAMILIES[family][0]][1]
    want = {axis: n * n_scans for axis, n in per_scan.items()}
    want["run"] += 1
    assert results[0][family]["collectives"] == want


def test_mesh_shapes_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="must divide K_HYP"):
        mesh_mod.make_mesh_2d(1, 3)
    with pytest.raises(ValueError, match="must divide atlas_max_tiles"):
        mesh_mod.make_mesh_map(1, 3, atlas_max_tiles=MAP_TILES)
    shard = collectives.AxisShard("map", "0", 0, 3)
    with pytest.raises(ValueError, match="must divide"):
        shard.block(MAP_TILES)
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_mod.make_mesh(2)


def test_a_mesh_outside_run_ranks_raises(tmp_path):
    """A process group that run_ranks did not start has no rank device: the
    mesh functions raise rather than pick one."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="inside run_ranks"):
            mesh_mod.make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_a_hung_rank_fails_within_the_time_limit():
    with pytest.raises(TimeoutError, match="did not finish within 8 s"):
        mesh_mod.run_ranks(ranks.hang, 2, "cpu", 1, timeout=8)


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh_mod.run_ranks(ranks.fail, 2, "cpu", 1, timeout=60)


def test_cuda_ranks_need_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards; 1 visible"):
        mesh_mod.run_ranks(ranks.fail, 2, "cuda", -1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh_mod.run_ranks(ranks.fail, 1, "cuda", -1)


def test_the_dry_run_holds_every_run_to_one_device(capsys):
    """parallel/dryrun on 2 gloo ranks: (run=1, hyp=2) and (run=1, map=2),
    each run within 1e-8 of the single-device reference (the CLI path)."""
    report = dryrun.main(["--devices", "2", "--cpu"])
    assert set(report) == {"run_hyp", "run_map"}
    assert report["run_hyp"]["mesh"] == {"run": 1, "hyp": 2} and report["run_map"]["mesh"] == {"run": 1, "map": 2}
    assert all(r["max_abs_err"] < dryrun.TOL for r in report.values())
    assert dryrun.families(4) == [("run_hyp", 1, 4), ("run_map", 1, 4)]
    assert dryrun.families(3) == [("run", 3, 1)]
    assert "dryrun (run, map) OK" in capsys.readouterr().out


def test_the_dry_run_needs_the_cards_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun.dryrun_multichip(2)
