"""The port's outputs against the JAX package's, on the CPU: the splat
renderer (outputs/rendering.py with the plain compositor of
outputs/raster.py), render_atlas from a JAX state, the TUM, splat-export and
diagnostics writers, and the viewer tool.

The renderer's texture is fBm value noise whose lattice hash is
|sin(s) * 43758.5453| mod 1, with s ~ 1e2-1e3: one ulp of sin(s) moves the
hash by ~3e-3 and one ulp of s by whole units. Evaluated op by op (eager
JAX, or PyTorch) the two packages see the same s and differ by sin's last
bit: noise within 5e-3 (99 % of points; the few whose |sin(s) * 43758|
lies within that of an integer wrap the mod 1 and differ by up to ~0.5),
albedo (noise_amp 0.15) within 1e-3 on the test scenes. Under jit,
XLA contracts the hash's multiply-adds into FMAs, so the jitted reference
draws another, equally valid, texture. The comparisons with the jitted
reference and its Pallas kernel therefore run with noise_amp = 0, and the
textured render is compared with the reference evaluated op by op."""

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models import runner as jrunner
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.outputs import diagnostics as jdiag, rendering as jr, splat_export as jsplat, tum as jtum
from gcslam_tpu.outputs.rendering_pallas import prepare_screen_splats as jprepare, render_splats_pallas
from gcslam_torch.frontend.synthetic import T_BASE_CAM
from gcslam_torch.models import scan_step as tstep
from gcslam_torch.ops import se3
from gcslam_torch.models.scan_step import ScanTape
from gcslam_torch.outputs import diagnostics as tdiag, raster, rendering as tr, splat_export as tsplat, tum as ttum
from gcslam_torch.tools import view_splats

SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
             surfel_voxel_size_m=0.5)
CAM = np.array([0.1, -0.2, 0.0, 0.02, -0.01, 0.03])


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def scene(P, seed=11):
    """Random splats in front of the camera, as tests/test_rendering_pallas.py."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3, 3, (P, 3))
    mu[:, 2] = rng.uniform(2, 8, P)
    A = rng.normal(0, 0.1, (P, 3, 3))
    Sigma = np.einsum("pij,pkj->pik", A, A) + 0.02 * np.eye(3)  # PSD
    return mu, Sigma, rng.normal(0, 1, (P, 3, 3)), rng.uniform(0, 1, (P, 3)), rng.uniform(0.5, 5, P)


def params(noise_amp):
    return dict(width=256, height=128, fx=128.0, fy=128.0, noise_amp=noise_amp)


def jrender(sc, p, fn=jr.render_splats):
    return [np.asarray(x) for x in fn(*[jnp.asarray(x) for x in sc], jnp.asarray(CAM), jr.RenderParams(**p))]


def trender(sc, p):
    return [x.numpy() for x in tr.render_splats(*[torch.as_tensor(x) for x in sc], torch.as_tensor(CAM),
                                                 tr.RenderParams(**p))]


def test_fbm_value_noise():
    p = np.random.default_rng(11).uniform(-3, 3, (20000, 3)).astype(np.float32)
    nj = np.asarray(jr._fbm_value_noise(jnp.asarray(p)))  # op by op
    nt = tr._fbm_value_noise(torch.as_tensor(p)).numpy()
    d = np.abs(nj - nt)
    # sin's last bit x 4.4e4: measured median 3e-6, 99 % 2.2e-3; mod-1 wraps at 0.02 %
    assert np.quantile(d, 0.99) < 5e-3 and (d > 5e-3).mean() < 5e-3
    assert np.abs(nj).max() > 0.1


def test_prepare_screen_splats():
    """Same projection as the Pallas wrapper's; the port's radius is the
    clip radius (4 sigma at log_clip = -8, +1 px) where the TPU's is 3 sigma."""
    sc = scene(48)
    pj = [np.asarray(x) for x in jprepare(*[jnp.asarray(x) for x in sc], jnp.asarray(CAM),
                                            jr.RenderParams(**params(0.0)))]
    pt = tr.prepare_screen_splats(*[torch.as_tensor(x) for x in sc], torch.as_tensor(CAM),
                                  tr.RenderParams(**params(0.0)))
    for name, j, t in zip(("u0", "v0", "inv2", "rgb", "alpha", "z"), pj, pt):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pt.radius.numpy(), 4.0 / 3.0 * pj[6] + 1.0, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_radius_bounds_every_nonzero_weight(seed):
    """Every pixel where q > log_clip lies within `radius` of the centre, so
    skipping a splat beyond it changes nothing."""
    sc = scene(64, seed)
    p = tr.RenderParams(**params(0.0))
    s = tr.prepare_screen_splats(*[torch.as_tensor(x) for x in sc], torch.as_tensor(CAM), p)
    us = torch.arange(p.width, dtype=torch.float32)[None, :]
    vs = torch.arange(p.height, dtype=torch.float32)[:, None]
    for i in range(s.u0.shape[0]):
        du, dv = us - s.u0[i], vs - s.v0[i]
        a, b, c = s.inv2[i]
        q = -0.5 * (a * du * du + 2.0 * b * du * dv + c * dv * dv)
        inside = (du.abs() <= s.radius[i]) & (dv.abs() <= s.radius[i])
        assert not bool(((q > p.log_clip) & ~inside).any()), i


def test_tiled_skip_equals_the_plain_compositor():
    """The kernel's schedule in plain PyTorch: 16 x 16 tiles, each splat
    skipped where its clip box misses the tile. Same image as the plain
    compositor over the whole frame (skipped weights are exactly 0; the
    1e-6 bound only leaves room for exp's vector/scalar tails)."""
    sc = scene(120, 3)
    p = tr.RenderParams(**params(0.0))
    s = tr.prepare_screen_splats(*[torch.as_tensor(x) for x in sc], torch.as_tensor(CAM), p)
    full = raster.composite_splats_reference(s, p.height, p.width, p.log_clip)
    tiled = [torch.zeros_like(x) for x in full]
    skipped = 0
    for y0 in range(0, p.height, 16):
        for x0 in range(0, p.width, 16):
            hit = ((s.u0 + s.radius >= x0) & (s.u0 - s.radius <= x0 + 15) & (s.v0 + s.radius >= y0)
                   & (s.v0 - s.radius <= y0 + 15) & (s.alpha > 0))
            skipped += int((~hit).sum())
            sub = raster.ScreenSplats(*[x[hit] for x in s])
            sub = sub._replace(u0=sub.u0 - x0, v0=sub.v0 - y0)
            out = raster.composite_splats_reference(sub, 16, 16, p.log_clip)
            for acc, o in zip(tiled, out):
                acc[y0:y0 + 16, x0:x0 + 16] = o
    assert skipped > 0.5 * s.u0.shape[0] * (p.height // 16) * (p.width // 16)
    for a, b in zip(full, tiled):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def composite_tile(s, idx, x0, y0, log_clip, tile=16):
    """The plain compositor's operations, in its order, over one tile's
    pixel coordinates and the splats `idx` (in that order)."""
    us = torch.arange(x0, x0 + tile, dtype=torch.float32)[None, :]
    vs = torch.arange(y0, y0 + tile, dtype=torch.float32)[:, None]
    rgb, depth, T = torch.zeros(tile, tile, 3), torch.zeros(tile, tile), torch.ones(tile, tile)
    b2 = 2.0 * s.inv2[:, 1]
    for p in idx.tolist():
        du, dv = us - s.u0[p], vs - s.v0[p]
        q = -0.5 * (s.inv2[p, 0] * du * du + b2[p] * du * dv + s.inv2[p, 2] * dv * dv)
        w = torch.where(q > log_clip, torch.exp(q), 0.0) * s.alpha[p]
        contrib = w * T
        rgb = rgb + contrib[..., None] * s.rgb[p]
        depth = depth + contrib * s.z[p]
        T = T * (1.0 - w)
    return rgb, depth, T


def ordered_compaction(hit, warp=32):
    """The kernel's slots for one chunk: each hit's rank among its warp's
    hits (ballot + popc of the lower lanes) plus the hits of the warps
    before it; returns the chunk-local indices in slot order."""
    h = hit.long()
    pad = (-h.numel()) % warp
    hw = torch.nn.functional.pad(h, (0, pad)).view(-1, warp)
    rank = torch.cumsum(hw, 1) - hw
    offset = torch.cumsum(hw.sum(1), 0) - hw.sum(1)
    slot = (rank + offset[:, None]).view(-1)[: h.numel()]
    staged = torch.full((int(h.sum()),), -1, dtype=torch.long)
    staged[slot[hit]] = torch.nonzero(hit).view(-1)
    return staged


@pytest.mark.parametrize("chunk", [256, 120, 50])
def test_chunked_compaction_equals_the_plain_compositor(chunk):
    """The kernel's schedule in plain PyTorch: per 16 x 16 tile, the splats in
    chunks (P = 120 below, equal to and not a multiple of the chunk), each
    chunk's tile test, its ordered compaction and the composite of its hits
    in slot order. Bit-equal to the plain compositor over the whole frame;
    the top-left tile, which no splat touches, stays empty."""
    sc = scene(120, 3)
    p = tr.RenderParams(**params(0.0))
    s = tr.prepare_screen_splats(*[torch.as_tensor(x) for x in sc], torch.as_tensor(CAM), p)
    # move the splats whose clip box meets the top-left tile clear of it
    near = (s.u0 - s.radius <= 15) & (s.v0 - s.radius <= 15)
    s = s._replace(u0=torch.where(near, 17.0 + s.radius, s.u0))
    full = raster.composite_splats_reference(s, p.height, p.width, p.log_clip)
    tiled = [torch.zeros_like(x) for x in full]
    n_hits = {}
    for y0 in range(0, p.height, 16):
        for x0 in range(0, p.width, 16):
            order = []
            for base in range(0, s.u0.shape[0], chunk):
                sl = slice(base, base + chunk)
                su, sv, r, al = s.u0[sl], s.v0[sl], s.radius[sl], s.alpha[sl]
                miss = ~(al > 0) | (su + r < x0) | (su - r > x0 + 15) | (sv + r < y0) | (sv - r > y0 + 15)
                staged = ordered_compaction(~miss)
                assert torch.equal(staged, torch.nonzero(~miss).view(-1))  # slots keep splat order
                order.append(base + staged)
            idx = torch.cat(order)
            n_hits[y0, x0] = idx.numel()
            for acc, o in zip(tiled, composite_tile(s, idx, x0, y0, p.log_clip)):
                acc[y0:y0 + 16, x0:x0 + 16] = o
    assert n_hits[0, 0] == 0 and max(n_hits.values()) > 0
    for a, b in zip(full, tiled):
        assert torch.equal(b, a)
    assert torch.equal(full[2][:16, :16], torch.ones(16, 16)) and not full[0][:16, :16].any()


@pytest.mark.parametrize("P", [48, 200])
def test_render_splats_matches_the_scan_compositor(P):
    """No texture: the jitted reference and the port differ by f32 rounding."""
    sc = scene(P)
    rj, dj = jrender(sc, params(0.0))
    rt, dt = trender(sc, params(0.0))
    assert np.isfinite(rt).all() and np.isfinite(dt).all()
    assert (rt.sum(-1) > 0.01).mean() > 0.2
    assert np.abs(rt - rj).max() < 1e-5  # measured 4.5e-7
    strong = (rj.sum(-1) > 0.3) & (dj > 0.1)
    assert (np.abs(dt - dj)[strong] / dj[strong]).max() < 1e-5  # measured 8.8e-7


def test_render_splats_against_the_pallas_kernel():
    """The interpreted TPU kernel, at tests/test_rendering_pallas.py's
    tolerances (its 3-sigma skip drops the 3-4 sigma tails the port keeps)."""
    sc = scene(48)
    rj, dj = jrender(sc, params(0.0), render_splats_pallas)
    rt, dt = trender(sc, params(0.0))
    assert np.abs(rt - rj).max() < 5e-3
    assert (rt.sum(-1) > 0.01).mean() > 0.2
    strong = (rj.sum(-1) > 0.3) & (dj > 0.1)
    rel = np.abs(dt[strong] - dj[strong]) / dj[strong]
    assert np.median(rel) < 1e-3 and np.quantile(rel, 0.99) < 0.05


def test_render_splats_with_texture():
    """Default noise amplitude against the reference op by op: the albedo
    tolerance 1e-3 = noise_amp x the noise bound (measured 1.1e-4)."""
    sc = scene(200)
    with jax.disable_jit():
        rj, dj = jrender(sc, params(0.15))
    rt, dt = trender(sc, params(0.15))
    assert np.abs(rt - rj).max() < 1e-3
    strong = (rj.sum(-1) > 0.3) & (dj > 0.1)
    assert (np.abs(dt - dj)[strong] / dj[strong]).max() < 1e-5


@pytest.fixture(scope="module")
def jrun():
    run = jgenerate(JSynth(n_scans=4, n_points=2048))
    state, out = jrunner.run_bag(run.batches, JConfig(**SMALL))
    return np_tree(state), np_tree(out)


def test_render_atlas_from_a_jax_state(jrun):
    jstate, jout = jrun
    ts = tstep.state_from_numpy(jstate, device="cpu")
    p = dict(width=64, height=48, fx=48.0, fy=48.0, noise_amp=0.0)
    # the last pose composed with the rig's camera extrinsic
    cam = se3.se3_compose(torch.as_tensor(jout.pose[-1]), torch.as_tensor(T_BASE_CAM)).numpy()
    rj, dj = [np.asarray(x) for x in jr.render_atlas(jax.tree_util.tree_map(jnp.asarray, jstate.atlas),
                                                        jnp.asarray(cam), jr.RenderParams(**p), max_splats=1024,
                                                        use_pallas=False)]
    rt, dt = [x.numpy() for x in tr.render_atlas(ts.atlas, torch.as_tensor(cam), tr.RenderParams(**p),
                                                  max_splats=1024, device="cpu")]
    assert (dt > 0).mean() > 0.2
    assert np.abs(rt - rj).max() < 1e-5
    strong = (rj.sum(-1) > 0.3) & (dj > 0.1)
    assert (np.abs(dt - dj)[strong] / dj[strong]).max() < 1e-5
    # the same splats are picked (top mass, lowest index first among ties)
    mu_t = tr.atlas_splats(ts.atlas, 1024)[0].numpy()
    k = min(1024, jstate.atlas.weights.size)
    w = np.where(jstate.atlas.valid, jstate.atlas.weights, -np.inf).reshape(-1)
    idx = np.asarray(jax.lax.top_k(jnp.asarray(w), k)[1])
    lam = jstate.atlas.Lambdas.reshape(-1, 3, 3)[idx].astype(np.float32)
    th = jstate.atlas.thetas.reshape(-1, 3)[idx].astype(np.float32)
    valid = np.isfinite(w[idx])
    mu_j = np.linalg.solve(lam[valid] + 1e-6 * np.eye(3), th[valid][..., None])[..., 0]
    np.testing.assert_allclose(mu_t[valid], mu_j, rtol=1e-3, atol=1e-4)


def test_tum_writer_and_reader(tmp_path):
    rng = np.random.default_rng(5)
    stamps = 1.7e9 + np.arange(20) * 0.1
    poses = np.concatenate([rng.normal(0, 3, (20, 3)), rng.normal(0, 1, (20, 3))], 1)
    poses[0, 3:] = 0.0
    jtum.write_tum(str(tmp_path / "j.tum"), stamps, poses)
    ttum.write_tum(str(tmp_path / "t.tum"), stamps, poses)
    assert (tmp_path / "j.tum").read_text() == (tmp_path / "t.tum").read_text()
    sj, pj = jtum.read_tum(str(tmp_path / "j.tum"))
    st, pt = ttum.read_tum(str(tmp_path / "t.tum"))
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(ttum.quat_to_rotvec(ttum.rotvec_to_quat(poses[:, 3:])), poses[:, 3:], atol=1e-12)


def test_splat_export(jrun, tmp_path):
    jstate, _ = jrun
    ts = tstep.state_from_numpy(jstate, device="cpu")
    dj = jsplat.atlas_to_splats(jstate.atlas)
    dt = tsplat.atlas_to_splats(ts.atlas)
    assert set(dj) == set(dt) and dj["mu_world"].shape[0] > 50
    for k in dj:
        assert dj[k].dtype == dt[k].dtype, k
        np.testing.assert_allclose(dt[k], dj[k], rtol=1e-12, atol=0, err_msg=k)
    n = tsplat.save_splat_export(str(tmp_path / "s.npz"), ts.atlas)
    assert n == dj["mu_world"].shape[0] and set(np.load(tmp_path / "s.npz").files) == set(dj)


def test_diagnostics_writers(jrun, tmp_path):
    _, jout = jrun
    ttape = ScanTape(*[torch.as_tensor(np.asarray(getattr(jout.tape, f)).astype(
        np.int64 if f == "cert_triggers" else np.asarray(getattr(jout.tape, f)).dtype)) for f in ScanTape._fields])
    jdiag.save_map_event_log(str(tmp_path / "j.jsonl"), jout.tape)
    tdiag.save_map_event_log(str(tmp_path / "t.jsonl"), ttape)
    assert (tmp_path / "j.jsonl").read_text() == (tmp_path / "t.jsonl").read_text()
    tdiag.save_diagnostics_npz(str(tmp_path / "d.npz"), ttape, torch.as_tensor(jout.pose), torch.as_tensor(jout.stamp))
    d = np.load(tmp_path / "d.npz")
    np.testing.assert_array_equal(d["poses"], jout.pose)
    assert set(d.files) == set(ScanTape._fields) | {"poses", "stamps"}
    assert tdiag.trigger_history(ttape) == jdiag.trigger_history(jout.tape)


@pytest.mark.parametrize("with_traj", [False, True])
def test_view_splats_on_the_cpu(jrun, tmp_path, with_traj):
    jstate, jout = jrun
    npz = tmp_path / "splat_export.npz"
    jsplat.save_splat_export(str(npz), jax.tree_util.tree_map(jnp.asarray, jstate.atlas))
    args = [str(npz), "--cpu", "--max-splats", "256", "--out", str(tmp_path / "views")]
    if with_traj:
        ttum.write_tum(str(tmp_path / "traj.tum"), jout.stamp, jout.pose)
        args += ["--traj", str(tmp_path / "traj.tum")]
    paths = view_splats.main(args)
    rgb, depth = np.load(paths["render_rgb.npy"]), np.load(paths["render_depth.npy"])
    assert rgb.shape == (360, 480, 3) and depth.shape == (360, 480)
    assert np.isfinite(rgb).all() and np.isfinite(depth).all() and (depth > 0).mean() > 0.01
    ppm = open(paths["render_rgb.ppm"], "rb").read()
    assert ppm.startswith(b"P6 480 360 255\n") and len(ppm) == len(b"P6 480 360 255\n") + 360 * 480 * 3


def test_entry_points_need_the_card_unless_asked_for_the_cpu(jrun, monkeypatch):
    """With no device given, the entry points run on the CUDA card; where
    there is none they raise (no silent CPU fallback)."""
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_io import batch_from_numpy

    jstate, _ = jrun
    batches = generate(SyntheticConfig(n_scans=1, n_points=64), device="cpu").batches
    ts = tstep.state_from_numpy(jstate, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: generate(SyntheticConfig(n_scans=1, n_points=64)),
        lambda: batch_from_numpy(batches[0]._asdict()),
        lambda: tstep.init_state(PipelineConfig(**SMALL)),
        lambda: tstep.state_from_numpy(jstate),
        lambda: runner.run_bag(batches, PipelineConfig(**SMALL)),
        lambda: tr.render_atlas(ts.atlas, torch.zeros(6)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
