"""gcslam_torch on the card: the CUDA Sinkhorn and splat-raster kernels
against their plain PyTorch versions, the scan step, the camera path, the
map render and the bag replay on CUDA against the same on the CPU, and the
bag decoder's build on the card's host.
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
from gcslam_torch.ops import se3, sinkhorn
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
    one Sinkhorn launch per GN round, each on all K_HYP problems."""
    from gcslam_torch import constants as C
    from gcslam_torch.ops import association

    batches = generate(SyntheticConfig(n_scans=3, n_points=512), device="cpu").batches
    cfg = PipelineConfig(map_share_extraction=False, map_gn_shared=False, **SMALL)
    _, cpu = runner.run_bag(batches, cfg, device="cpu")
    shapes = []
    real = association.sinkhorn_unbalanced

    def recording(Cm, *args):
        shapes.append(tuple(Cm.shape))
        return real(Cm, *args)

    association.sinkhorn_unbalanced = recording
    try:
        before = sinkhorn.COUNTER.launches
        _, gpu = runner.run_bag(batches, cfg, device=cuda)
        launches = sinkhorn.COUNTER.launches - before
    finally:
        association.sinkhorn_unbalanced = real
    assert launches == cfg.map_icp_iters * 3
    assert shapes == [(C.K_HYP, cfg.n_surfel, cfg.k_assoc)] * launches
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
    scan, on the H100); and every launch is attributed to a function."""
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
