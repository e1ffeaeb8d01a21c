"""gcslam_torch on the card: the CUDA Sinkhorn, splat-raster and eigen
kernels against their plain PyTorch versions, the scan step, the camera
path, the map render and the bag replay on CUDA against the same on the
CPU, the compiled step (a captured CUDA graph) against the eager step, and
the bag decoder's build on the card's host.
Marked `cuda`; skips where torch.cuda.is_available() is false. This file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gcslam_torch.frontend.synthetic import T_BASE_CAM, SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import eigh, se3, sinkhorn
from gcslam_torch.outputs import raster, rendering

pytestmark = pytest.mark.cuda

ARGS = (0.05, 1.0, 1.0, 50)
# f32: the Pallas test's tolerance (other summation orders); f64: 1e-10
TOL = {torch.float32: dict(rtol=2e-5, atol=1e-7), torch.float64: dict(rtol=1e-10, atol=1e-30)}
SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
             surfel_voxel_size_m=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(B, N, K, seed):
    rng = np.random.default_rng(seed)
    shape = (N,) if B is None else (B, N)
    C = rng.uniform(0.0, 5.0, size=shape + (K,))
    valid = rng.uniform(size=shape) > 0.33
    a = valid / np.maximum(valid.sum(-1, keepdims=True), 1e-9)
    return C, a, np.full(shape[:-1] + (K,), 1.0 / K), ~valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,N,K", [(None, 1024, 8), (4, 1024, 8), (None, 1536, 8), (None, 257, 8),
                                   (2, 100, 20), (None, 1, 8), (None, 129, 8), (None, 2048, 8), (4, 257, 20)])
def test_kernel_matches_plain(cuda, dtype, B, N, K):
    """One cluster per problem (1 to 8 blocks by N): the plain loop's result,
    zero-mass rows exactly 0, and two launches bit-equal."""
    C, a, b, zero = _case(B, N, K, seed=N + K)
    t = [torch.as_tensor(x, dtype=dtype, device=cuda) for x in (C, a, b)]
    before = sinkhorn.COUNTER.launches
    out = sinkhorn.sinkhorn_unbalanced(*t, *ARGS)
    out2 = sinkhorn.sinkhorn_unbalanced(*t, *ARGS)
    ref = sinkhorn.sinkhorn_unbalanced_reference(*t, *ARGS)
    torch.cuda.synchronize()
    assert sinkhorn.COUNTER.launches == before + 2
    assert torch.equal(out, out2)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert torch.all(out[torch.as_tensor(zero, device=cuda)] == 0)


def test_launcher_layout_is_the_cluster_layout(cuda):
    for N in (1, 129, 257, 1024, 1025, 1536, 2048):
        cl, _, threads = sinkhorn.cluster_layout(N)
        assert sinkhorn.launcher_layout(N) == (cl, threads)


@pytest.mark.parametrize("n_iters", [0, 1])
def test_kernel_at_few_iterations(cuda, n_iters):
    C, a, b, _ = _case(None, 1024, 8, seed=3)
    t = [torch.as_tensor(x, device=cuda) for x in (C, a, b)]
    args = (0.05, 1.0, 1.0, n_iters)
    torch.testing.assert_close(sinkhorn.sinkhorn_unbalanced(*t, *args),
                               sinkhorn.sinkhorn_unbalanced_reference(*t, *args), **TOL[torch.float64])


def test_kernel_refuses_cpu_and_oversized_inputs(cuda):
    C, a, b, _ = _case(None, 64, 8, seed=0)
    t = [torch.as_tensor(x, device=cuda) for x in (C, a, b)]
    with pytest.raises(ValueError):
        sinkhorn.sinkhorn_unbalanced(t[0], t[1].cpu(), t[2], *ARGS)
    big = torch.zeros(64, 40, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        sinkhorn.sinkhorn_unbalanced(big, t[1], torch.full((40,), 0.025, dtype=torch.float64, device=cuda),
                                     *ARGS)


def test_run_bag_on_cuda_matches_cpu(cuda):
    """The same 5 scans on the card and on the CPU: the kernel and the plain
    loop, and cuBLAS and CPU reductions, sum in other orders (rtol 1e-10 per
    call); poses agree to a few micrometres."""
    batches = generate(SyntheticConfig(n_scans=5, n_points=512), device="cpu").batches
    cfg = PipelineConfig(**SMALL)
    _, cpu = runner.run_bag(batches, cfg, device="cpu")
    before = sinkhorn.COUNTER.launches
    _, gpu = runner.run_bag(batches, cfg, device=cuda)
    assert sinkhorn.COUNTER.launches - before == cfg.map_icp_iters * 5
    np.testing.assert_allclose(gpu.pose.cpu().numpy(), cpu.pose.numpy(), rtol=0, atol=1e-5)


def test_per_hypothesis_run_bag_on_cuda_matches_cpu(cuda):
    """The per-hypothesis map branch (map_share_extraction=False,
    map_gn_shared=False) over 3 scans on the card and on the CPU: poses
    within the tolerance of test_run_bag_on_cuda_matches_cpu, and on the card
    one Sinkhorn launch per GN round, each on all K_HYP problems (counted
    over the compiled step's replays: its captured association runs once)."""
    from gcslam_torch import constants as C

    batches = generate(SyntheticConfig(n_scans=3, n_points=512), device="cpu").batches
    cfg = PipelineConfig(map_share_extraction=False, map_gn_shared=False, **SMALL)
    _, cpu = runner.run_bag(batches, cfg, device="cpu")
    sinkhorn.COUNTER.reset()
    _, gpu = runner.run_bag(batches, cfg, device=cuda)
    assert sinkhorn.COUNTER.launches == cfg.map_icp_iters * 3
    assert sinkhorn.COUNTER.shapes == {(C.K_HYP, cfg.n_surfel, cfg.k_assoc)}
    np.testing.assert_allclose(gpu.pose.cpu().numpy(), cpu.pose.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("lead", [(3,), (2, 4)], ids=["runs", "runs_x_hyps"])
def test_vmapped_kernel_is_one_launch_equal_to_per_problem_launches(cuda, lead):
    """Under torch.func.vmap the custom op's rule folds (R, N, K) and
    (R, K_HYP, N, K) into one launch of B = R or R * K_HYP problems; each
    problem is its own cluster, so the result equals per-problem launches
    bit for bit."""
    B = int(np.prod(lead))
    C, a, b, _ = _case(B, 1024, 8, seed=5)
    Cm = torch.as_tensor(C, device=cuda).reshape(lead + (1024, 8))
    am = torch.as_tensor(a, device=cuda).reshape(lead + (1024,))
    bv = torch.as_tensor(b[0], device=cuda)
    f = lambda c, x: sinkhorn.sinkhorn_unbalanced(c, x, bv, *ARGS)  # noqa: E731
    for _ in lead:
        f = torch.func.vmap(f)
    sinkhorn.COUNTER.reset()
    out = f(Cm, am)
    assert sinkhorn.COUNTER.launches == 1 and sinkhorn.COUNTER.shapes == {(B, 1024, 8)}
    per = torch.stack([sinkhorn.sinkhorn_unbalanced(c, x, bv, *ARGS)
                       for c, x in zip(Cm.reshape(B, 1024, 8), am.reshape(B, 1024))])
    assert sinkhorn.COUNTER.launches == 1 + B
    assert torch.equal(out, per.reshape(out.shape))


def test_sweep_on_cuda_equals_run_bag_per_run(cuda):
    """parallel/sweep at R = 2, map on, 3 scans: each run equals its
    run_bag (batched and single-run reductions round apart at ~1e-16 on
    the CPU), with one Sinkhorn launch per GN round for both runs."""
    from gcslam_torch.parallel import sweep

    runs = [generate(SyntheticConfig(n_scans=3, n_points=512, seed=s), device="cpu").batches for s in range(2)]
    cfg = PipelineConfig(**SMALL)
    sinkhorn.COUNTER.reset()
    _, outs, aggs = sweep.run_sweep(runs, cfg, device=cuda)
    assert sinkhorn.COUNTER.launches == cfg.map_icp_iters * 3
    assert sinkhorn.COUNTER.shapes == {(2, cfg.n_surfel, cfg.k_assoc)}
    for r, batches in enumerate(runs):
        _, single = runner.run_bag(batches, cfg, device=cuda)
        np.testing.assert_allclose(outs.pose[r].cpu().numpy(), single.pose.cpu().numpy(), rtol=0, atol=1e-8)
    assert torch.isfinite(aggs[-1]["pose_spread"]) and float(aggs[-1]["pose_spread"]) > 0


def _splats(P, H, W, device, seed=11):
    """Screen splats of a seeded random scene (tests/test_rendering_pallas.py's
    recipe, scaled to the image)."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3, 3, (P, 3))
    mu[:, 2] = rng.uniform(2, 8, P)
    A = rng.normal(0, 0.1, (P, 3, 3))
    Sigma = np.einsum("pij,pkj->pik", A, A) + 0.02 * np.eye(3)
    sc = [mu, Sigma, rng.normal(0, 1, (P, 3, 3)), rng.uniform(0, 1, (P, 3)), rng.uniform(0.5, 5, P)]
    p = rendering.RenderParams(width=W, height=H, fx=0.75 * W, fy=0.75 * W)
    return rendering.prepare_screen_splats(*[torch.as_tensor(x, device=device) for x in sc],
                                           torch.zeros(6, dtype=torch.float64, device=device), p), p


@pytest.mark.parametrize("P,H,W", [(4096, 240, 320), (4096, 360, 480), (300, 100, 130), (1, 17, 23)])
def test_raster_kernel_matches_plain(cuda, P, H, W):
    """Built with --fmad=false the kernel does the plain loop's operations in
    its order: rgb to 1e-5 (the bound chip_smoke.py holds it to)."""
    s, p = _splats(P, H, W, cuda)
    before = raster.COUNTER.launches
    rgb, depth, T = raster.composite_splats(s, H, W, p.log_clip)
    rgb2, depth2, T2 = raster.composite_splats(s, H, W, p.log_clip)
    ref = raster.composite_splats_reference(s, H, W, p.log_clip)
    torch.cuda.synchronize()
    assert raster.COUNTER.launches == before + 2
    assert torch.equal(rgb, rgb2) and torch.equal(depth, depth2) and torch.equal(T, T2)
    for got, want in zip((rgb, depth, T), ref):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("P,H,W", [(1, 48, 64), (257, 64, 80), (4096, 240, 320)])
def test_raster_kernel_leaves_an_untouched_tile_empty(cuda, P, H, W):
    """Splats moved clear of the top-left tile: there the kernel's ordered
    compaction finds no hit in any chunk (rgb 0, depth 0, T 1); elsewhere it
    equals the plain compositor; repeats are bit-equal."""
    s, p = _splats(P, H, W, cuda, seed=P)
    near = (s.u0 - s.radius <= 15) & (s.v0 - s.radius <= 15)
    s = s._replace(u0=torch.where(near, 17.0 + s.radius, s.u0).contiguous())
    out = raster.composite_splats(s, H, W, p.log_clip)
    out2 = raster.composite_splats(s, H, W, p.log_clip)
    ref = raster.composite_splats_reference(s, H, W, p.log_clip)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(out, out2))
    for got, want in zip(out, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    rgb, depth, T = out
    assert not rgb[:16, :16].any() and not depth[:16, :16].any() and bool((T[:16, :16] == 1).all())


def test_raster_kernel_refuses_what_it_does_not_take(cuda):
    s, p = _splats(64, 32, 32, cuda)
    with pytest.raises(TypeError):
        raster.composite_splats(s._replace(z=s.z.double()), 32, 32, p.log_clip)
    with pytest.raises(ValueError):
        raster.composite_splats(s._replace(alpha=s.alpha.cpu()), 32, 32, p.log_clip)
    with pytest.raises(ValueError):
        raster.composite_splats(s._replace(inv2=s.inv2.t().contiguous().t()), 32, 32, p.log_clip)
    with pytest.raises(ValueError):
        raster.composite_splats(s, 0, 32, p.log_clip)


def test_camera_run_bag_on_cuda_matches_cpu(cuda):
    """The camera-on replay on the pure route: frontend on each device (the
    same corners: the filters are shifted sums, exact on both), then 5 scans
    at the SMALL budgets on each; poses agree to a few micrometres."""
    cfg = PipelineConfig(with_camera=True, **SMALL)
    run_cpu = generate(SyntheticConfig(n_scans=5, n_points=512, with_camera=True), device="cpu", native=False)
    run_gpu = generate(SyntheticConfig(n_scans=5, n_points=512, with_camera=True), device=cuda, native=False)
    for bc, bg in zip(run_cpu.batches, run_gpu.batches):
        assert bg.cam_valid.is_cuda and torch.equal(bc.cam_valid, bg.cam_valid.cpu())
        torch.testing.assert_close(bg.cam_etas.cpu(), bc.cam_etas, rtol=1e-5, atol=1e-6)
    state_cpu, cpu = runner.run_bag(run_cpu.batches, cfg, device="cpu")
    before = sinkhorn.COUNTER.launches
    state_gpu, gpu = runner.run_bag(run_cpu.batches, cfg, device=cuda)
    assert sinkhorn.COUNTER.launches - before == cfg.map_icp_iters * 5
    np.testing.assert_allclose(gpu.pose.cpu().numpy(), cpu.pose.numpy(), rtol=0, atol=1e-5)
    assert float(state_gpu.atlas.cam_mass.sum()) > 0

    # the map render on the card (kernel) and on the CPU (plain loop)
    params = rendering.RenderParams(width=160, height=120, fx=120.0, fy=120.0)
    cam = se3.se3_compose(gpu.pose[-1].cpu(), torch.as_tensor(T_BASE_CAM))  # where the camera looked
    before = raster.COUNTER.launches
    rgb_g, depth_g = rendering.render_atlas(state_gpu.atlas, cam, params, max_splats=1024)
    rgb_c, depth_c = rendering.render_atlas(state_gpu.atlas, cam, params, max_splats=1024, device="cpu")
    assert raster.COUNTER.launches == before + 1 and rgb_g.is_cuda
    assert float((depth_c > 0).float().mean()) > 0.05
    # the same splats through the kernel and the plain loop on the card
    s = rendering.prepare_screen_splats(*rendering.atlas_splats(state_gpu.atlas, 1024), cam.to(cuda), params)
    for got, want in zip(raster.composite_splats(s, params.height, params.width, params.log_clip),
                         raster.composite_splats_reference(s, params.height, params.width, params.log_clip)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # across devices the projection's texture hash sees sin's last bit
    # (measured 8.5e-5 on 58 of 57600 values; albedo bound 1e-3)
    torch.testing.assert_close(rgb_g.cpu(), rgb_c, rtol=0, atol=1e-3)


def test_camera_native_route_on_cuda_matches_cpu(cuda):
    """The generator's default route (the C++ corner stage on the host, the
    lift on each device), then 5 scans at the SMALL budgets on each. The
    native stage keeps 62-81 corners a frame (the pure route > 200), so the
    young map's first match (scan 2) leans on the LiDAR surfels, whose
    float32 rounding moves scan 3's pose by ~2e-5 m across devices (2.6e-5 m
    measured on the H100; 1.6e-5 m between the packages on the CPU,
    tests/test_torch_native_route.py): poses are held at 1e-4 m. The
    camera rows are float64 lifts of float32 LiDAR operands reduced in
    other orders on each device: 1.05e-9 relative measured on the H100,
    held at 1e-8."""
    cfg = PipelineConfig(with_camera=True, **SMALL)
    run_cpu = generate(SyntheticConfig(n_scans=5, n_points=512, with_camera=True), device="cpu")
    run_gpu = generate(SyntheticConfig(n_scans=5, n_points=512, with_camera=True), device=cuda)
    for bc, bg in zip(run_cpu.batches, run_gpu.batches):
        assert bg.cam_valid.is_cuda and torch.equal(bc.cam_valid, bg.cam_valid.cpu())
        assert int(bc.cam_valid.sum()) > 50
        torch.testing.assert_close(bg.cam_Lambdas.cpu(), bc.cam_Lambdas, rtol=1e-8,
                                   atol=1e-12 * float(bc.cam_Lambdas.abs().max()))
    _, cpu = runner.run_bag(run_cpu.batches, cfg, device="cpu")
    _, gpu = runner.run_bag(run_gpu.batches, cfg, device=cuda)
    np.testing.assert_allclose(gpu.pose.cpu().numpy(), cpu.pose.numpy(), rtol=0, atol=1e-4)


def test_bag_decoder_builds_from_a_clean_build_dir(cuda, tmp_path, monkeypatch):
    """The bag decoder (csrc/bag_decode.cpp) builds with g++ on the card's
    host into an empty build directory, loads and parses a cloud."""
    from gcslam_torch import constants as C
    from gcslam_torch.frontend import bag_synth, cdr, native

    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    path = native.build()
    assert path.parent == tmp_path / "build" and [p.name for p in path.parent.iterdir()] == [path.name]
    n = 64
    rng = np.random.default_rng(1)
    raw = np.zeros((n, 22), dtype=np.uint8)
    xyz = rng.normal(0, 5, (n, 3)).astype("<f4")
    raw[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    buf = cdr.serialize_pointcloud2(cdr.PointCloud2(cdr.Header(3.5, "lidar"), 1, n, bag_synth._FIELDS, False, 22,
                                                    22 * n, raw.tobytes(), True))
    got, _, _, _, stamp = native.parse_pointcloud2(buf, 128, C.NONFINITE_SENTINEL)
    np.testing.assert_array_equal(got, xyz)
    assert stamp == 3.5


@pytest.mark.parametrize("with_camera", [False, True], ids=["lidar", "camera"])
def test_bag_load_and_replay_on_cuda_match_cpu(cuda, tmp_path, with_camera):
    """A 6-scan Kimera-schema bag: load_bag on the card and on the CPU gives
    the same LiDAR, IMU, odometry and time fields (host-built, bit-equal)
    and camera rows lifted on each device (float64 reductions in other
    orders: rtol 1e-9); run_bag at the SMALL budgets on each: poses within
    the tolerance of test_run_bag_on_cuda_matches_cpu, one Sinkhorn launch
    per GN round on the card."""
    import dataclasses
    import pathlib

    from gcslam_torch.frontend import rosbag
    from gcslam_torch.frontend.bag_synth import write_synth_bag

    config = pathlib.Path(__file__).resolve().parent.parent / "configs" / "gc_kimera.yaml"
    base = rosbag.bag_config_from_file(str(config))
    bag_cfg = dataclasses.replace(base, n_points=512, with_camera=with_camera,
                                  camera_intrinsics=tuple(x * 80 / 640 for x in base.camera_intrinsics))
    bag = str(tmp_path / "bag.db3")
    write_synth_bag(bag, SyntheticConfig(n_scans=6, n_points=1024, seed=0), bag_cfg,
                    gt_path=str(tmp_path / "gt.tum"), cam_size=(80, 60))
    cpu_b, _, _ = rosbag.load_bag(bag, config=bag_cfg, device="cpu")
    gpu_b, _, _ = rosbag.load_bag(bag, config=bag_cfg)
    assert len(cpu_b) == len(gpu_b) == 6 and gpu_b[0].points.is_cuda
    for bc, bg in zip(cpu_b, gpu_b):
        for name in bc._fields:
            a, b = getattr(bc, name), getattr(bg, name).cpu()
            if name.startswith("cam_") and a.is_floating_point():
                torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-12 * float(a.abs().max()))
            else:
                assert torch.equal(a, b), name
    if with_camera:
        assert min(int(b.cam_valid.sum()) for b in gpu_b) > 0
    cfg = PipelineConfig(with_camera=with_camera, **SMALL)
    _, cpu = runner.run_bag(cpu_b, cfg, device="cpu")
    before = sinkhorn.COUNTER.launches
    _, gpu = runner.run_bag(gpu_b, cfg)
    assert sinkhorn.COUNTER.launches - before == cfg.map_icp_iters * 6
    np.testing.assert_allclose(gpu.pose.cpu().numpy(), cpu.pose.numpy(), rtol=0, atol=1e-5)


_F32_CHILD = r"""
import json
import numpy as np
import torch
from gcslam_torch.eval.ate_rpe import compute_ate
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import association, sinkhorn
from gcslam_torch.utils.dtypes import BELIEF_DTYPE

calls = []
kernel = association.sinkhorn_unbalanced
association.sinkhorn_unbalanced = lambda C, *a, **k: calls.append((str(C.dtype), tuple(C.shape))) or kernel(C, *a, **k)
run = generate(SyntheticConfig(n_scans=5, n_points=8192))
before = sinkhorn.COUNTER.launches
_, out = runner.run_bag(run.batches, PipelineConfig())
launches = sinkhorn.COUNTER.launches - before
flagship_calls = sorted(set(calls))
small = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)
srun = generate(SyntheticConfig(n_scans=5, n_points=512), device="cpu")
_, cpu = runner.run_bag(srun.batches, PipelineConfig(**small), device="cpu")
_, gpu = runner.run_bag(srun.batches, PipelineConfig(**small))
print(json.dumps({
    "dtype": str(BELIEF_DTYPE), "pose_dtype": str(out.pose.dtype), "launches": launches, "calls": flagship_calls,
    "finite": bool(torch.isfinite(out.pose).all()),
    "ate": compute_ate(out.pose.double().cpu().numpy(), run.gt_poses)["translation"]["rmse"],
    "small_cpu_vs_cuda": float((gpu.pose.cpu() - cpu.pose).abs().max()),
}))
"""


def test_f32_belief_flagship_on_cuda(cuda):
    """The f32-belief mode (a child process with GCSLAM_BELIEF_DTYPE set):
    5 flagship scans launch the Sinkhorn's f32 instance, two per scan at
    (1024, 8); the SMALL world's f32 replay on the card and on the CPU agree
    within the tolerance of test_run_bag_on_cuda_matches_cpu scaled to
    float32 (1e-3)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, GCSLAM_BELIEF_DTYPE="float32",
               PYTHONPATH=os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", _F32_CHILD], env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["dtype"] == r["pose_dtype"] == "torch.float32" and r["finite"]
    assert r["launches"] == 10 and r["calls"] == [["torch.float32", [1024, 8]]]
    assert r["ate"] < 0.30
    assert r["small_cpu_vs_cuda"] < 1e-3, r["small_cpu_vs_cuda"]


def test_camera_bag_at_640x480_through_eval_run(cuda, tmp_path):
    """The canonical route on the card at the camera's full size: a 4-scan
    bag from tools/make_synth_bag with the rehearsal's arguments (640 x 480
    JPEG + 16UC1 frames), then eval.run --chunk 10 --loop --live-view at
    configs/gc_kimera.yaml's budgets: every artifact, the audit passing,
    one live.jsonl line per scan, two Sinkhorn launches per scan, each at
    (n_surfel + n_feat, k_assoc) = (1024, 8)."""
    import json
    import pathlib

    from gcslam_torch.eval import run as eval_run
    from gcslam_torch.ops import association
    from gcslam_torch.tools import make_synth_bag

    config = str(pathlib.Path(__file__).resolve().parent.parent / "configs" / "gc_kimera.yaml")
    bag, gt = str(tmp_path / "b.db3"), str(tmp_path / "gt.tum")
    make_synth_bag.main(["--out", bag, "--gt", gt, "--config", config, "--scans", "4", "--points", "4096"])
    shapes = []
    kernel = association.sinkhorn_unbalanced

    def recording(C, *a, **k):
        shapes.append(tuple(C.shape))
        return kernel(C, *a, **k)

    association.sinkhorn_unbalanced = recording
    try:
        before = sinkhorn.COUNTER.launches
        metrics = eval_run.main(["--bag", bag, "--config", config, "--gt", gt, "--chunk", "10", "--loop",
                                 "--live-view", str(tmp_path / "live"), "--out", str(tmp_path / "run")])
        launches = sinkhorn.COUNTER.launches - before
    finally:
        association.sinkhorn_unbalanced = kernel
    assert metrics["n_scans"] == 4 and metrics["device"] == "cuda"
    assert json.load(open(tmp_path / "run" / "audit.json"))["all_pass"]
    lines = [json.loads(line) for line in open(tmp_path / "live" / "live.jsonl")]
    assert [e["scan"] for e in lines if "pose" in e] == [0, 1, 2, 3]
    assert launches == 8 and set(shapes) == {(1024, 8)}


def test_eval_run_precision_f32_on_cuda(cuda, tmp_path):
    """`eval.run --precision f32` on the card: the CLI re-executes itself
    with GCSLAM_BELIEF_DTYPE=float32; the manifest records the float32
    belief and the CUDA device, and the trajectory is finite."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "GCSLAM_BELIEF_DTYPE"}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(root), env.get("PYTHONPATH")]))
    out = subprocess.run([sys.executable, "-m", "gcslam_torch.eval.run", "--precision", "f32", "--scans", "3",
                          "--points", "2048", "--out", str(tmp_path / "run")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    manifest = json.load(open(tmp_path / "run" / "runtime_manifest.json"))
    assert manifest["belief_dtype"] == "float32" and manifest["device_runtime"]["platform"] == "cuda"
    assert np.isfinite(np.loadtxt(tmp_path / "run" / "trajectory.tum")).all()


def test_run_bag_commits_host_batches_once(cuda):
    """Host batches replayed on the card: one host-to-device commit of every
    field's bytes, nothing read back and no host sync before the gather;
    poses bit-equal to the replay of the same batches already on the card."""
    from gcslam_torch.utils.profiling import COUNTERS

    cfg = PipelineConfig(**SMALL)
    host = generate(SyntheticConfig(n_scans=4, n_points=1024), device="cpu").batches
    COUNTERS.reset()
    _, out = runner.run_bag(host, cfg, device=cuda)
    ledger = COUNTERS.cert()
    assert (ledger["h2d_calls"], ledger["d2h_bytes"], ledger["host_syncs"]) == (1, 0, 0)
    assert ledger["h2d_bytes"] == sum(x.nbytes for b in host for x in b)
    _, out2 = runner.run_bag([b.to(cuda) for b in host], cfg, device=cuda)
    assert torch.equal(out.pose, out2.pose)


def test_compute_cert_reads_peak_memory_on_the_card(cuda):
    from gcslam_torch.models.manifest import compute_cert

    a = torch.randn(1024, 1024, device=cuda)
    cert, out = compute_cert(lambda x: x @ x, a)
    assert cert["matmul_flops"] == 2 * 1024 ** 3
    assert cert["peak_allocated_bytes"] >= a.nbytes + out.nbytes
    assert cert["peak_above_start_bytes"] >= out.nbytes


def test_kernel_census_counts_the_profilers_launches(cuda):
    """The census's launch calls of one SMALL scan are profile_record's on
    the same scan from the same state (one definition of a launch), to
    0.1 %: under the census's dispatch mode the step makes 3 launches more
    (27,119 against 27,116 at SMALL, 27,132 against 27,129 on a flagship
    scan, on the H100); and every launch is attributed to a function; the
    scan's Lie-group calls are one launch each (78 at SMALL as on a
    flagship scan)."""
    from gcslam_torch.models.scan_step import scan_step
    from gcslam_torch.tools import kernel_census
    from gcslam_torch.utils.cuda_profile import profile_record

    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=4, n_points=1024), device=cuda)
    state, _ = runner.run_bag(run.batches[:3], cfg, device=cuda)
    with torch.no_grad():
        ref = profile_record(lambda: scan_step(state, run.batches[3], cfg), 1)
        rep = kernel_census.census(lambda: scan_step(state, run.batches[3], cfg), True)
    assert rep["launch_calls_per_scan"] == rep["attributed_launches"]
    assert sum(rep["lie_launches_by_op"].values()) == LIE_CALLS_PER_FLAGSHIP_SCAN
    assert abs(rep["launch_calls_per_scan"] - ref["launch_calls_per_scan"]) <= 1e-3 * ref["launch_calls_per_scan"]
    assert rep["device_kernels_per_scan"] > 0 and rep["d2d_copies"] >= 0
    top = rep["top_functions"]
    assert sum(r["launches"] for r in top) <= rep["launch_calls_per_scan"]
    assert [r["launches"] for r in top] == sorted((r["launches"] for r in top), reverse=True)
    assert top[0]["function"].startswith("gcslam_torch/") and top[0]["device_us"] > 0


def test_microbench_scatter_on_the_card(cuda):
    """Every strategy at the production shapes on the card; the checksums
    agree to the JAX tool's three decimals, and the production route
    (index_put with accumulate: sorted, in order) is bit-reproducible where
    index_add's atomics need not be."""
    from gcslam_torch.tools import microbench_scatter

    rows = microbench_scatter.run(cuda, reps=2)
    for group in ("surfel", "TM"):
        chk = [r["checksum"] for r in rows if group in r["name"] or (group == "TM" and "pool" in r["name"])]
        assert max(chk) - min(chk) <= 1e-3
    again = {r["name"]: r["out"] for r in microbench_scatter.run(cuda, reps=1)}
    for r in rows:
        if r["name"].startswith("binned_scatter_accumulate"):
            assert torch.equal(r["out"], again[r["name"]])


def _sym_batch(shape, n, seed, dtype):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=shape + (n, n))
    return torch.as_tensor(A @ np.swapaxes(A, -1, -2) - 0.5 * n * np.eye(n), dtype=dtype)


# eigh3: the kernel does the plain chain's rotations in IEEE order, but the
# chain's 3 x 3 products go to cuBLAS (other sums, fused multiply-adds):
# eigenvalues and the reconstruction V diag(lam) V^T agree within a few
# ulp of max|lam|
EIGH3_RTOL = {torch.float64: 1e-14, torch.float32: 1e-6}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (4, 3), (8192,)])
def test_eigh3_kernel_matches_plain(cuda, dtype, shape):
    M = _sym_batch(shape, 3, seed=len(shape) + 3, dtype=dtype).to(cuda)
    before = eigh.EIGH3_COUNTER.launches
    lam, V = eigh.eigh3(M)
    lam2, V2 = eigh.eigh3(M)
    ref_lam, ref_V = eigh.eigh3_reference(M)
    torch.cuda.synchronize()
    assert eigh.EIGH3_COUNTER.launches == before + 2
    assert torch.equal(lam, lam2) and torch.equal(V, V2)
    scale = ref_lam.abs().amax(-1, keepdim=True)
    assert torch.all((lam - ref_lam).abs() <= EIGH3_RTOL[dtype] * scale)
    rec = (V * lam[..., None, :]) @ V.transpose(-1, -2)
    ref_rec = (ref_V * ref_lam[..., None, :]) @ ref_V.transpose(-1, -2)
    assert torch.all((rec - ref_rec).abs().amax((-2, -1)) <= 4 * EIGH3_RTOL[dtype] * scale[..., 0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,shape", [(6, ()), (6, (7,)), (22, (1,)), (22, (4,)), (5, (3,)), (32, (2,)), (1, (2,)),
                                     (22, (2,)), (22, (8,)), (22, (32,)), (6, (56,)), (31, (1,)), (2, (3,))])
def test_eigh_sym_kernel_matches_plain(cuda, dtype, n, shape):
    """The kernel performs its plain version's operations in order (both
    built without contraction): equal to the bit; and close to
    torch.linalg.eigh."""
    M = _sym_batch(shape, n, seed=n, dtype=dtype).to(cuda)
    before = eigh.EIGH_SYM_COUNTER.launches
    lam, V = eigh.eigh_sym(M)
    ref_lam, ref_V = eigh.eigh_sym_reference(M)
    torch.cuda.synchronize()
    assert eigh.EIGH_SYM_COUNTER.launches == before + 1
    assert torch.equal(lam, ref_lam) and torch.equal(V, ref_V)
    lib = torch.linalg.eigvalsh(M)
    tol = {torch.float64: 1e-13, torch.float32: 1e-5}[dtype]
    assert torch.all((lam - lib).abs() <= tol * lib.abs().amax(-1, keepdim=True))


def _clustered_22(seed: int, count: int) -> np.ndarray:
    """The first `count` clustered 22 x 22 matrices that
    tests/test_torch_eigh.py's _matrices draws from `seed` (two clusters of
    11 eigenvalues, 1e-13 apart inside each, rotated at random), in numpy
    alone: this file imports no JAX."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        Q = np.linalg.qr(rng.normal(size=(22, 22)))[0]
        lam = np.concatenate([np.full(11, 1.0), np.full(11, 1e-3)]) * (1.0 + 1e-13 * rng.normal(size=22))
        M = (Q * lam) @ Q.T
        out.append(0.5 * (M + M.T))
    return np.stack(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eigh_sym_kernel_on_the_slowest_clustered_matrices(cuda, dtype):
    """The matrices that set EIGH_SYM_SWEEPS (test_sweeps_converge: seeds
    0-2 and seed 26's sixth, the slowest found), alone and as one batch:
    equal to the plain version to the bit, two launches equal."""
    M = torch.as_tensor(np.concatenate([_clustered_22(s, 2) for s in range(3)] + [_clustered_22(26, 6)[5:6]]),
                        dtype=dtype, device=cuda)
    for batch in (M[-1], M):
        lam, V = eigh.eigh_sym(batch)
        lam2, V2 = eigh.eigh_sym(batch)
        ref_lam, ref_V = eigh.eigh_sym_reference(batch)
        torch.cuda.synchronize()
        assert torch.equal(lam, ref_lam) and torch.equal(V, ref_V)
        assert torch.equal(lam, lam2) and torch.equal(V, V2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [6, 22, 5])
def test_eigh_sym_kernel_nan_gives_nan(cuda, dtype, n):
    """A NaN entry gives NaN eigenvalues in every matrix it touches and
    leaves the others of the batch as they are; the launch ends (no
    convergence loop to hang in)."""
    M = _sym_batch((3,), n, seed=n + 1, dtype=dtype).to(cuda)
    M[1, 0, 1] = float("nan")
    lam, V = eigh.eigh_sym(M)
    torch.cuda.synchronize()
    assert torch.isnan(lam[1]).all()
    ref_lam, ref_V = eigh.eigh_sym_reference(M[::2])
    assert torch.equal(lam[::2], ref_lam) and torch.equal(V[::2], ref_V)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sym_chain_kernel_matches_plain(cuda, dtype):
    """eigh_sym's latency probe (one thread, the rotation lane's chain)
    equals its plain version on the card to the bit, at the rounds of a
    6 x 6 and a 22 x 22 call."""
    blk = _sym_batch((), 4, seed=4, dtype=dtype).to(cuda)
    for n in (6, 22):
        got = eigh.sym_chain(blk, eigh.sym_rounds(n))
        want = eigh.sym_chain_reference(blk, eigh.sym_rounds(n))
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.isfinite(got).all()


def test_eigh_vmap_is_one_launch_and_refuses_what_it_does_not_take(cuda):
    M = _sym_batch((3, 2), 22, seed=1, dtype=torch.float64).to(cuda)
    before = eigh.EIGH_SYM_COUNTER.launches
    out = torch.func.vmap(eigh.eigh_sym)(M)
    assert eigh.EIGH_SYM_COUNTER.launches == before + 1 and (6, 22, 22) in eigh.EIGH_SYM_COUNTER.shapes
    per = [eigh.eigh_sym(M[r]) for r in range(3)]
    assert torch.equal(out[0], torch.stack([p[0] for p in per]))
    with pytest.raises(ValueError):
        eigh.eigh_sym(torch.zeros(2, 33, 33, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        eigh.eigh3(torch.zeros(2, 3, 3, dtype=torch.float16, device=cuda))
    lam, V = eigh.eigh3(torch.zeros(0, 3, 3, dtype=torch.float64, device=cuda))
    assert lam.shape == (0, 3) and V.shape == (0, 3, 3)


# psd3 (the fused 3 x 3 PSD projection) against its plain version
# (psd_parts through eigh3_reference, whose 3 x 3 products and
# reconstruction go to cuBLAS and whose norms are torch reductions): M_psd,
# eig_min and eig_max within EIGH3_RTOL of max|lambda|, the two deltas
# within EIGH3_RTOL of |M|, near_null_count equal
EPS_PSD = 1e-12


def _psd_inputs(shape, dtype, cuda, seed):
    """Symmetric batches with eigenvalues around and below the PSD floor,
    indefinite ones, a zero matrix and (as the last of a batch of at least
    3) a NaN entry."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape, dtype=int))
    Q = np.linalg.qr(rng.normal(size=(max(n, 1), 3, 3)))[0]
    lam = 10 ** rng.uniform(-14, 1, (max(n, 1), 3)) * rng.choice([-1.0, 1.0], (max(n, 1), 3))
    M = np.einsum("bik,bk,bjk->bij", Q, lam, Q)[:n] + 1e-3 * rng.normal(size=(n, 3, 3))
    if n >= 2:
        M[1] = 0.0
    M = torch.as_tensor(M.reshape(shape + (3, 3)), dtype=dtype, device=cuda)
    return M


def _check_psd3(M, got, want, dtype):
    from gcslam_torch.ops import linalg

    (P, c), (P_p, c_p) = got, want
    lam = eigh.eigh3(linalg.sym(M))[0]
    scale = lam.abs().amax(-1)
    norm = torch.linalg.matrix_norm(M)
    tol = EIGH3_RTOL[dtype]
    assert torch.all((P - P_p).abs().amax((-2, -1)) <= tol * scale)
    assert torch.all((c[..., :2] - c_p[..., :2]).abs().amax(-1) <= tol * norm)
    assert torch.all((c[..., 2:4] - c_p[..., 2:4]).abs().amax(-1) <= tol * scale)
    assert torch.equal(c[..., 5], c_p[..., 5])
    vals = torch.clamp(lam, min=EPS_PSD)
    assert torch.equal(c[..., 2], vals.amin(-1)) and torch.equal(c[..., 3], vals.amax(-1))
    assert torch.equal(c[..., 4], c[..., 3] / c[..., 2])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(), (1,), (3,), (4,), (2, 4), (1024,), (8192,), (129,)])
def test_psd3_kernel_matches_plain(cuda, dtype, shape):
    """One launch (the psd3 counter moves, eigh3's does not), two launches
    bit-equal, the plain version within the tolerances above, eig_min /
    eig_max the floored extremes of eigh3's eigenvalues, and a zero matrix
    gives cond 1."""
    M = _psd_inputs(shape, dtype, cuda, seed=len(shape) + 7)
    before, before3 = eigh.PSD3_COUNTER.launches, eigh.EIGH3_COUNTER.launches
    got = eigh.psd3(M, EPS_PSD)
    got2 = eigh.psd3(M, EPS_PSD)
    assert eigh.PSD3_COUNTER.launches == before + 2 and eigh.EIGH3_COUNTER.launches == before3
    want = eigh.psd3_reference(M, EPS_PSD)
    torch.cuda.synchronize()
    assert got[0].shape == M.shape and got[1].shape == M.shape[:-2] + (6,)
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    _check_psd3(M, got, want, dtype)
    if M.dim() == 3 and M.shape[0] >= 2:
        assert got[1][1, 4] == 1.0 and got[1][1, 5] == 3.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_psd3_kernel_nan_gives_nan(cuda, dtype):
    """A NaN entry gives a NaN M_psd and NaN certificate fields (the floor
    keeps NaN, as torch.clamp does), near_null_count 0 (NaN < x is false),
    and leaves the other matrices of the batch as they are."""
    M = _psd_inputs((4,), dtype, cuda, seed=3)
    M[2, 0, 1] = float("nan")
    P, c = eigh.psd3(M, EPS_PSD)
    torch.cuda.synchronize()
    assert torch.isnan(P[2]).all() and torch.isnan(c[2, :5]).all() and c[2, 5] == 0.0
    P_ok, c_ok = eigh.psd3(M[[0, 1, 3]], EPS_PSD)
    assert torch.equal(P[[0, 1, 3]], P_ok) and torch.equal(c[[0, 1, 3]], c_ok)


def test_domain_projection_3x3_is_one_psd3_launch(cuda):
    """On the card linalg.domain_projection_psd of a (..., 3, 3) batch
    dispatches psd3 and a view of its certificate and nothing else (so its
    one launch is the only kernel: chip_smoke.py phase 2 counts the
    kernels in a profiler trace), moves psd3's counter by one, and returns
    the certificate as views of one tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gcslam_torch.ops import linalg

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    M = _psd_inputs((4,), torch.float64, cuda, seed=5)
    before = eigh.PSD3_COUNTER.launches
    with Ops() as rec:
        M_psd, cert = linalg.domain_projection_psd(M)
    assert rec.ops == ["gcslam.psd3.default", "aten.unbind.int"]
    assert eigh.PSD3_COUNTER.launches == before + 1
    assert all(f.untyped_storage().data_ptr() == cert.cond.untyped_storage().data_ptr() for f in cert)


def test_merged_calls_equal_separate_calls_on_the_card(cuda):
    """The step's merged eigen calls give the separate calls' bits on the
    card: every matrix of a batch gets the same thread's arithmetic."""
    from gcslam_torch.ops import evidence_pose, iw, linalg

    rng = np.random.default_rng(21)
    A = rng.normal(size=(3, 3, 3))
    st = iw.MeasurementNoiseIW(nu=torch.as_tensor(rng.uniform(5, 10, 3), device=cuda),
                               Psi=torch.as_tensor(A @ A.transpose(0, 2, 1), device=cuda))
    merged = iw.measurement_noise_modes(st)
    assert torch.equal(merged, torch.stack([iw.measurement_noise_mode(st, i) for i in range(3)]))
    for batch in ((), (4,)):
        B = rng.normal(size=batch + (6, 6))
        L6 = torch.as_tensor(B @ np.swapaxes(B, -1, -2), device=cuda)
        eig_t, eig_r = evidence_pose.block_eigvals(L6)
        assert torch.equal(eig_t, linalg.eigh_3x3(linalg.sym(L6[..., 0:3, 0:3]))[0])
        assert torch.equal(eig_r, linalg.eigh_3x3(linalg.sym(L6[..., 3:6, 3:6]))[0])
    S = _psd_inputs((2, 4), torch.float64, cuda, seed=9)
    P, cert = linalg.domain_projection_psd(S)
    for i in range(2):
        P_i, cert_i = linalg.domain_projection_psd(S[i])
        assert torch.equal(P[i], P_i) and all(torch.equal(a[i], b) for a, b in zip(cert, cert_i))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eigh3_chain_kernel_matches_plain(cuda, dtype):
    """eigh3's latency probe (one thread, its 18 rotations' chain) equals
    its plain version on the card to the bit."""
    M = _psd_inputs((3,), dtype, cuda, seed=2)
    for m in M:
        got, want = eigh.eigh3_chain(m), eigh.eigh3_chain_reference(m)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    eigh.empty_launch(cuda)
    torch.cuda.synchronize()


def test_psd3_vmap_is_one_launch_and_a_graph_captures_it(cuda):
    """A vmapped psd3 is one launch equal to per-run launches; a CUDA graph
    captures the launch (outputs from torch.empty, no host sync) and its
    replays equal eager launches on new inputs."""
    M = _psd_inputs((3, 2), torch.float64, cuda, seed=4)
    before = eigh.PSD3_COUNTER.launches
    out = torch.func.vmap(lambda m: eigh.psd3(m, EPS_PSD))(M)
    assert eigh.PSD3_COUNTER.launches == before + 1
    per = [eigh.psd3(M[r], EPS_PSD) for r in range(3)]
    assert torch.equal(out[0], torch.stack([p[0] for p in per])) and torch.equal(out[1], torch.stack([p[1] for p in per]))
    static = M.clone()
    eigh.psd3(static, EPS_PSD)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = eigh.psd3(static, EPS_PSD)
    for seed in (5, 6):
        static.copy_(_psd_inputs((3, 2), torch.float64, cuda, seed=seed))
        graph.replay()
        eager = eigh.psd3(static, EPS_PSD)
        torch.cuda.synchronize()
        assert torch.equal(captured[0], eager[0]) and torch.equal(captured[1], eager[1])


def test_an_eager_step_makes_no_implicit_sync(cuda):
    from gcslam_torch.models.scan_step import init_state, scan_step

    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=3, n_points=1024), device=cuda)
    with torch.no_grad():
        state, _ = scan_step(init_state(cfg, device=cuda), run.batches[0], cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for b in run.batches[1:]:
                state, out = scan_step(state, b, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.pose).all()


def test_compiled_step_replays_equal_the_eager_step(cuda):
    """run_bag on the card replays the captured step: poses and tape equal
    the eager scan_step loop's bit for bit, the Sinkhorn counts two launches
    a scan over the replays, and a second run_bag replays every scan."""
    from gcslam_torch.models.scan_step import init_state
    from gcslam_torch.utils.tree import tree_leaves

    cfg = PipelineConfig(**SMALL)
    batches = generate(SyntheticConfig(n_scans=6, n_points=1024), device=cuda).batches
    runner.release_graphs()
    sinkhorn.COUNTER.reset()
    state_g, out_g = runner.run_bag(batches, cfg, device=cuda)
    step = runner.compiled_steps()[-1]
    assert step.graph is not None and step.replays == 5 and step.capture_s > 0
    assert sinkhorn.COUNTER.launches == cfg.map_icp_iters * 6
    state_e, out_e = runner.eager_steps(init_state(cfg, device=cuda), batches, cfg)
    for a, b in zip(tree_leaves(out_e) + tree_leaves(state_e), tree_leaves(out_g) + tree_leaves(state_g)):
        assert torch.equal(a, b)
    sinkhorn.COUNTER.reset()
    _, out_2 = runner.run_bag(batches, cfg, device=cuda)
    assert step.replays == 11 and sinkhorn.COUNTER.launches == cfg.map_icp_iters * 6
    assert torch.equal(out_2.pose, out_g.pose)
    runner.release_graphs()


def test_stage_clock_in_the_graph(cuda):
    """The compiled step with its stage clock against the same step captured
    without it: poses, tapes and state bit-equal at every replay; the clock
    counts every replay, and its stages sum to 0.9-1.0 of the CUDA events
    around the replays; a run_bag from a state on the card (the replay
    path) makes no implicit host sync."""
    from gcslam_torch.models.scan_step import init_state
    from gcslam_torch.utils.cuda_profile import implicit_syncs
    from gcslam_torch.utils.profiling import STAGES
    from gcslam_torch.utils.tree import tree_leaves

    cfg = PipelineConfig(**SMALL)
    batches = generate(SyntheticConfig(n_scans=8, n_points=1024), device=cuda).batches
    runner.release_graphs()
    state0 = init_state(cfg, device=cuda)
    outs, elapsed_ms = {}, None
    with torch.no_grad():
        for with_clock in (True, False):
            step = runner.CompiledStep(cfg, state0, batches[0], stage_clock=with_clock)
            step.step(batches[0])  # eager, then the capture
            if with_clock:
                step.stage_clock.reset()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            outs[with_clock] = [[x.clone() for x in tree_leaves(step.step(b))] for b in batches[1:]]
            t1.record()
            outs[with_clock].append(tree_leaves(step.state))
            torch.cuda.synchronize()
            if with_clock:
                reading, replays, elapsed_ms = step.stage_clock.read(), step.replays, t0.elapsed_time(t1)
            else:
                assert step.stage_clock is None
    for got, want in zip(outs[True], outs[False]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert reading.scans == replays == len(batches) - 1 and list(reading.stage_ns) == list(STAGES)
    assert all(v > 0 for v in reading.stage_ns.values()), reading
    stages_ms = sum(reading.stage_ns.values()) / 1e6
    assert 0.9 * elapsed_ms <= stages_ms <= elapsed_ms, (stages_ms, elapsed_ms)
    state, _ = runner.run_bag(batches, cfg, device=cuda)  # the cached graph's capture
    assert not implicit_syncs(lambda: runner.run_bag(batches, cfg, state=state, device=cuda))
    assert runner.stage_reading().scans == (len(batches) - 1) + len(batches)
    runner.release_graphs()


# --- the Lie-group maps and the 3 x 3 inverse (csrc/se3.cu) -------------------

# A flagship scan's launches of the Lie-group kernel (gcslam::lie and
# gcslam::inv3x3) by op and batch shape (a census on the CPU,
# PipelineConfig(), 8192 points: 78 calls a scan), plus the se3_inverse
# the kernel also serves and a broadcast compose.
LIE_SHAPES = {
    "so3_exp": [(), (4,), (512,), (2, 4, 512), (8192,)],
    "so3_log": [(), (4,), (2, 4)],
    "se3_exp": [(), (4,), (8192,)],
    "se3_log": [(), (4,)],
    "se3_compose": [(), (4,), ((4,), ())],
    "se3_inverse": [(4,)],
    "se3_relative": [(4,), ((4,), ())],
    "skew": [(1024,)],
    "inv3x3": [(), (4,), (7, 4), (7, 64), (7, 128), (1024,), (7168,)],
}
LIE_CALLS_PER_FLAGSHIP_SCAN = 78
# outputs that pass through a 3 x 3 product or a reduction (cuBLAS, torch's
# sums, norms and softmax in the plain version): within these of the
# output's largest entry; skew and inv3x3 are elementwise: bit-equal
LIE_RTOL = {torch.float64: 2e-15, torch.float32: 1e-6}
LIE_ELEMENTWISE = {"skew", "inv3x3"}


def _lie_operands(op, shape, dtype, device, seed):
    """Operands of an op at a batch shape (a pair of shapes for a broadcast
    two-pose call), shaped as the step's: rotation vectors of norm up to 2
    rad, poses with translations of ~1 m; se3_compose's second pose a small
    increment (<= 0.3 rad, ~0.3 m), se3_relative's first pose the second
    composed with such an increment (as the step composes a pose with an
    odometry or Gauss-Newton step, and takes the relative pose of nearby
    poses); inv3x3's matrices symmetric positive definite, as the step's
    information matrices. So no output lies near pi, where so3_log's
    generic branch scales a last-bit difference of the 3 x 3 product by
    theta / sin(theta)."""
    from gcslam_torch.ops import se3

    rng = np.random.default_rng(seed)
    two = se3.OPS[op][1] is not None
    shapes = shape if isinstance(shape[0] if shape else None, tuple) else (shape,) * (1 + two)

    def rotvec(batch, max_angle):
        v = rng.normal(size=batch + (3,))
        return v / np.linalg.norm(v, axis=-1, keepdims=True) * rng.uniform(0.0, max_angle, size=batch + (1,))

    def pose(batch, scale, max_angle):
        return torch.as_tensor(np.concatenate([scale * rng.normal(size=batch + (3,)), rotvec(batch, max_angle)], -1),
                               device=device)

    if op in ("so3_exp", "skew"):
        args = [torch.as_tensor(rotvec(shapes[0], 2.0), device=device)]
    elif op == "so3_log":
        args = [se3.so3_exp_reference(torch.as_tensor(rotvec(shapes[0], 2.0), device=device))]
    elif op == "inv3x3":
        A = rng.normal(size=shapes[0] + (3, 3))
        args = [torch.as_tensor(A @ np.swapaxes(A, -1, -2) + 0.01 * np.eye(3), device=device)]
    elif op == "se3_compose":
        args = [pose(shapes[0], 1.0, 2.0), pose(shapes[1], 0.3, 0.3)]
    elif op == "se3_relative":
        b = pose(shapes[1], 1.0, 2.0)
        args = [se3.se3_compose_reference(b, pose(shapes[0], 0.3, 0.3)), b]
    else:
        args = [pose(shapes[0], 1.0, 2.0)]
    return [a.to(dtype) for a in args]


def _lie_call(op, args, plain=False):
    from gcslam_torch.ops import linalg, se3

    if op == "inv3x3":
        return (linalg.inv3x3_reference if plain else linalg.inv3x3)(args[0], 1e-9)
    return getattr(se3, f"{op}_reference" if plain else op)(*args)


def _check_lie(op, got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    assert torch.isfinite(got).all()
    if op in LIE_ELEMENTWISE:
        assert torch.equal(got, want), (op, float((got - want).abs().max()))
    else:
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= LIE_RTOL[dtype], (op, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op,shape", [(op, s) for op, shapes in LIE_SHAPES.items() for s in shapes])
def test_lie_kernel_matches_plain(cuda, dtype, op, shape):
    """One launch a call at a flagship scan's shapes, two launches
    bit-equal, the plain version on the card to the bit (elementwise ops)
    or within LIE_RTOL of the output's largest entry."""
    from gcslam_torch.ops import se3

    args = _lie_operands(op, shape, dtype, cuda, seed=len(str(shape)) + len(op))
    before = se3.LIE_COUNTER.launches
    got, got2 = _lie_call(op, args), _lie_call(op, args)
    assert se3.LIE_COUNTER.launches == before + 2
    want = _lie_call(op, args, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, got2)
    _check_lie(op, got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", list(LIE_SHAPES))
def test_lie_kernel_on_every_branch(cuda, dtype, op):
    """The edge cases of tests/test_torch_se3_kernel.py on the card
    (theta = 0, < 1e-7, in (1e-7, 1e-4), near pi, pi; singular, zero and
    badly scaled 3 x 3 matrices): the plain version's branch and value.
    se3_compose composes each pose with itself (angles 2 theta: 0, small,
    generic, 2 pi - 2e-6, 2 pi). se3_relative takes the relative pose of
    each pose and the pose composed with a step, a small one (~1 cm, ~0.01
    rad: nearby poses, as the step compares) and a large one (~1 m, ~0.6
    rad); its error is held to the size of its operands, since the
    inverse's rounding (its rotation near pi carries ulp(pi) into the
    composition) is of that size whatever the size of the relative pose."""
    from gcslam_torch.ops import se3
    from test_torch_se3_kernel import operands

    args = [a.to(cuda) for a in operands(op, dtype)]
    if op == "se3_relative":
        for step in ([0.01, -0.006, 0.004, 0.002, 0.005, -0.003], [1.0, -0.6, 0.4, 0.2, 0.5, -0.3]):
            step = torch.tensor(step, dtype=dtype, device=cuda)
            a = [se3.se3_compose_reference(args[0], step), args[0]]
            got, want = _lie_call(op, a), _lie_call(op, a, plain=True)
            torch.cuda.synchronize()
            scale = max(float(x.abs().max()) for x in a + [want])
            assert torch.isfinite(got).all() and got.shape == want.shape
            assert float((got - want).abs().max()) <= LIE_RTOL[dtype] * scale, (step, got - want)
        return
    if op == "se3_compose":
        args[1] = args[0]
    got, want = _lie_call(op, args), _lie_call(op, args, plain=True)
    torch.cuda.synchronize()
    if op == "inv3x3":  # the zero matrix's inverse is 1 / eps_rel on the diagonal: finite
        assert torch.equal(got, want)
    else:
        _check_lie(op, got, want, dtype)


def test_lie_vmap_graph_and_refusals(cuda):
    """A vmapped call is one launch, bit-equal to a launch per run (one
    thread's arithmetic an element); a CUDA graph captures the launch and
    its replays equal eager launches; the wrapper refuses a dtype, a
    trailing shape and mixed operands it does not take."""
    from gcslam_torch.ops import se3

    a = _lie_operands("se3_compose", (3, 4), torch.float64, cuda, seed=1)
    b0 = a[1][0, 0]
    before = se3.LIE_COUNTER.launches
    out = torch.func.vmap(se3.se3_compose, in_dims=(0, None))(a[0], b0)
    assert se3.LIE_COUNTER.launches == before + 1
    assert torch.equal(out, torch.stack([se3.se3_compose(a[0][r], b0) for r in range(3)]))
    w = a[0][..., 3:6].clone()
    before = se3.LIE_COUNTER.launches
    R = torch.func.vmap(se3.so3_exp, in_dims=1)(w)
    assert se3.LIE_COUNTER.launches == before + 1
    assert torch.equal(R, torch.stack([se3.so3_exp(w[:, r]) for r in range(4)]))
    static = w.clone()
    se3.so3_log(se3.so3_exp(static))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = se3.so3_log(se3.so3_exp(static))
    for seed in (2, 3):
        static.copy_(torch.as_tensor(np.random.default_rng(seed).normal(size=(3, 4, 3)), device=cuda))
        graph.replay()
        eager = se3.so3_log(se3.so3_exp(static))
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    with pytest.raises(TypeError):
        se3.so3_exp(w.half())
    with pytest.raises(ValueError):
        se3.so3_exp(a[0])
    with pytest.raises(TypeError):
        se3.se3_compose(a[0], a[1].float())


def test_a_flagship_scan_launches_the_lie_kernel_once_a_call(cuda):
    """An eager flagship scan (PipelineConfig(), 8192 points) dispatches
    every call of the Lie maps and inv3x3 as one operator, gcslam::lie or
    gcslam::inv3x3, 78 of them, and no other op from those functions; LIE_COUNTER counts 78
    launches, and a profiler trace of the scan holds 78 lie_kernel records;
    the replays of run_bag count the same launches a scan."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gcslam_torch.models.scan_step import init_state, scan_step
    from gcslam_torch.ops import se3
    from gcslam_torch.tools.kernel_census import _caller
    from gcslam_torch.utils import cuda_profile

    lie_functions = {f"gcslam_torch/ops/se3.py:{f}" for f in list(se3.OPS) + ["lie"]} | {
        "gcslam_torch/ops/linalg.py:inv3x3"}

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append((str(func), _caller()))
            return func(*args, **(kwargs or {}))

    cfg = PipelineConfig()
    run = generate(SyntheticConfig(n_scans=4, n_points=8192), device=cuda)
    with torch.no_grad():
        state = init_state(cfg, device=cuda)
        for b in run.batches[:3]:
            state, _ = scan_step(state, b, cfg)
        se3.LIE_COUNTER.reset()
        with Ops() as rec:
            scan_step(state, run.batches[3], cfg)
        assert se3.LIE_COUNTER.launches == LIE_CALLS_PER_FLAGSHIP_SCAN, dict(se3.LIE_COUNTER.by_instance)
        from_lie = [op for op, caller in rec.ops if caller in lie_functions]
        assert len(from_lie) == LIE_CALLS_PER_FLAGSHIP_SCAN, sorted(set(from_lie))
        assert set(from_lie) == {"gcslam.lie.default", "gcslam.inv3x3.default"}, sorted(set(from_lie))
        prof, _ = cuda_profile.profile(lambda: scan_step(state, run.batches[3], cfg))
        kernels = [e.name() for e in cuda_profile.device_activity(cuda_profile.raw_events(prof))]
        assert sum("lie_kernel" in k for k in kernels) == LIE_CALLS_PER_FLAGSHIP_SCAN
    se3.LIE_COUNTER.reset()
    runner.release_graphs()
    runner.run_bag(run.batches, cfg, device=cuda)
    torch.cuda.synchronize()
    assert se3.LIE_COUNTER.launches == LIE_CALLS_PER_FLAGSHIP_SCAN * len(run.batches)
    runner.release_graphs()


def test_lie_kernel_holds_the_plain_version_on_a_flagship_scan(cuda):
    """Every launch of the Lie-group kernel in an eager flagship scan
    (PipelineConfig(), 8192 points, scan 3), replayed on its own operands
    against the plain version on the card: skew and inv3x3 to the bit, the
    rest within LIE_RTOL of the output's largest entry."""
    from gcslam_torch.models.scan_step import init_state, scan_step
    from gcslam_torch.ops import linalg, se3

    calls = {}
    launch = se3.launch

    def recording(op, a, b=None, eps=0.0):
        calls.setdefault((op, a.dtype, se3.batch_shape(op, a, b)), (a.clone(), None if b is None else b.clone(), eps))
        return launch(op, a, b, eps)

    cfg = PipelineConfig()
    run = generate(SyntheticConfig(n_scans=4, n_points=8192), device=cuda)
    with torch.no_grad():
        state = init_state(cfg, device=cuda)
        for b in run.batches[:3]:
            state, _ = scan_step(state, b, cfg)
        se3.launch = recording
        try:
            scan_step(state, run.batches[3], cfg)
        finally:
            se3.launch = launch
    assert len(calls) >= 20 and any(k[0] == "inv3x3" for k in calls)
    for (op, dtype, batch), (a, b, eps) in sorted(calls.items(), key=str):
        got = se3.launch(op, a, b, eps)
        want = linalg.inv3x3_reference(a, eps) if op == "inv3x3" else se3.lie_reference(op, a, b)
        torch.cuda.synchronize()
        _check_lie(op, got, want, dtype)
