"""gcslam_torch on the card: the CUDA Sinkhorn and splat-raster kernels
against their plain PyTorch versions, and the scan step, the camera path
and the map render on CUDA against the same on the CPU.
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
    """The camera-on replay: frontend on each device (the same corners: the
    filters are shifted sums, exact on both), then 5 scans at the SMALL
    budgets on each; poses agree to a few micrometres."""
    cfg = PipelineConfig(with_camera=True, **SMALL)
    run_cpu = generate(SyntheticConfig(n_scans=5, n_points=512, with_camera=True), device="cpu")
    run_gpu = generate(SyntheticConfig(n_scans=5, n_points=512, with_camera=True), device=cuda)
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
