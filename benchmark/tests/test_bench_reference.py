"""The plain reference against the program on the CPU, at a tiny size: the
eager step, the loop detector, the bag decode and the native corner
stage's numpy mirror agree bit for bit (the CPU runs the program's plain
routes; the card's kernels are what the comparison on the card judges)."""

import numpy as np
import pytest
import torch

from benchmark.reference import check
from conftest import with_kept
from benchmark.reference.plain.frontend import native as rnative, rosbag as rrosbag, synthetic as rsyn
from benchmark.reference.plain.models import config as rconfig, scan_step as rstep
from gcslam_torch.frontend import bag_synth, native, rosbag, synthetic
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig

torch.set_num_threads(2)
SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)


@pytest.mark.parametrize("camera", [False, True])
def test_step(camera):
    """The reference's generator, step and loop detector against the
    program's run_stream, which the reference follows here from its own
    init_state over every scan."""
    cfg = dict(n_scans=6, n_points=512, with_camera=camera, trajectory="circuit", odom_model="integrated")
    prog = synthetic.generate(synthetic.SyntheticConfig(**cfg), device="cpu", native=False)
    ref = rsyn.generate(rsyn.SyntheticConfig(**cfg), device="cpu", native=False)
    for x, y in zip(prog.batches, ref.batches):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    st, out = runner.run_stream(prog.batches, PipelineConfig(**SMALL, with_camera=camera), device="cpu")
    rcfg = rconfig.PipelineConfig(**SMALL, with_camera=camera)
    s = rstep.init_state(rcfg, device="cpu")
    poses = []
    with torch.no_grad():
        for b in ref.batches:
            s, o = rstep.scan_step(s, b, rcfg)
            poses.append(o.pose)
    assert torch.equal(out.pose, torch.stack(poses))
    assert check.mismatches(check.state_tree(st), check.state_tree(s)) == 0


def test_compare_reads_zero_on_the_cpu():
    cfg = dict(n_scans=6, n_points=512)
    ref = rsyn.generate(rsyn.SyntheticConfig(**cfg), device="cpu")
    pcfg = PipelineConfig(**SMALL)
    s1, o1 = runner.run_bag([runner.ScanBatch(*b) for b in ref.batches[:3]], pcfg, device="cpu")
    s2, o2 = runner.run_bag([runner.ScanBatch(*b) for b in ref.batches[3:]], pcfg, state=s1, device="cpu")
    tapes = {f: np.concatenate([getattr(o1.tape, f).numpy(), getattr(o2.tape, f).numpy()]) for f in o1.tape._fields}
    rec = check.PassRecord(ref_batches=ref.batches, poses=torch.cat([o1.pose, o2.pose]).numpy(), tapes=tapes,
                           states={3: check.state_tree(s1), 6: check.state_tree(s2)}, segments=[(0, 1), (3, 3)])
    from gcslam_torch.models.scan_step import init_state

    numbers = check.compare(rec, {"pipeline": SMALL}, check.state_tree(init_state(pcfg, device="cpu")), "cpu")
    assert numbers == dict(init_mismatch=0.0, pose_gap_m=0.0, rot_gap_rad=0.0, tape_gap_median=0.0,
                           state_gap_median=0.0)
    rec.poses = rec.poses.copy()
    rec.poses[4, 0] += 1e-3
    assert check.compare(rec, {"pipeline": SMALL}, check.state_tree(init_state(pcfg, device="cpu")),
                         "cpu")["pose_gap_m"] == pytest.approx(1e-3)


@pytest.mark.parametrize("shape,max_feat", [((48, 64), 512), ((120, 160), 64), ((480, 640), 512)])
def test_visual_features(shape, max_feat):
    rng = np.random.default_rng(sum(shape))
    H, W = shape
    g = (rng.random((H, W)) * 255).astype(np.uint8)
    g[:, : W // 3] = g[:, : W // 3] // 16 * 16  # plateaus: ties in the scores
    d = (1 + rng.random((H, W))).astype(np.float32)
    d[rng.random((H, W)) < 0.2] = 0
    a = native.visual_features(g, d, max_feat=max_feat)
    b = rnative.visual_features(g, d, max_feat=max_feat)
    assert a[0] == b[0] > 0
    for x, y in zip(a[1:5], b[1:5]):  # uv, score, z, z_var (the normal is dropped by the port)
        assert np.array_equal(x[:a[0]], y[:a[0]])


def test_nth_element_partitions():
    rng = np.random.default_rng(0)
    for n in (2, 5, 17, 300):
        v = [(float(x), i) for i, x in enumerate(rng.integers(0, 7, n))]
        for nth in (0, n // 3, n - 1):
            w = list(v)
            rnative.nth_element(w, nth, lambda a, b: a[0] > b[0])
            assert sorted(w) == sorted(v)
            assert all(x[0] >= w[nth][0] for x in w[:nth]) and all(x[0] <= w[nth][0] for x in w[nth + 1:])


def test_decode(tmp_path):
    from benchmark import spec

    cell = spec.load_cell("kimera-bag", spec=with_kept(spec.load_spec()))
    fe = dict(cell.config["frontend"], n_points=1024)
    path = str(tmp_path / "b.db3")
    bag_synth.write_synth_bag(path, synthetic.SyntheticConfig(n_scans=5, n_points=4096, trajectory="circuit",
                                                              odom_model="integrated"),
                              rosbag.bag_config_from_dict(fe, base_dir=cell.config_dir), cam_size=(640, 480))
    a = rosbag.load_bag(path, config=rosbag.bag_config_from_dict(fe, base_dir=cell.config_dir), device="cpu")[0]
    b = rrosbag.load_bag(path, config=rrosbag.bag_config_from_dict(fe, base_dir=cell.config_dir), device="cpu")[0]
    assert len(a) == len(b) == 5 and sum(int(x.cam_valid.sum()) for x in a) > 100
    assert sum(check.mismatches(check.state_tree(x), check.state_tree(y)) for x, y in zip(a, b)) == 0
