"""The port's camera path against the JAX package's, on the CPU: the visual
frontend (frontend/camera.py) function by function at 160 x 120 with 512
features, the generator's camera branch, and the map code that camera rows
reach (association and pose factor, fuse/insert with colour, merge).

Two properties of the reference bound how close the ports can be:
  - Harris runs in float32, and the synthetic world's 0.5 m checker texture
    makes plateaus of equal corner response along straight edges. Which
    plateau pixel survives NMS and top-K follows the last bit of the filter
    sums, and the two packages sum in other orders (XLA's convolution vs
    shifted sums). On smooth textures, where no two responses are within
    rounding, the corners are identical; on the checker world ~95 % are.
  - The LiDAR depth evidence is float32 too, and its Route-B precision is
    planarity / lambda_min of a neighbourhood covariance. Where the
    neighbourhood is (near) rank-deficient, lambda_min sits at its 1e-6
    floor plus rounding, so that precision follows the rounding. On clouds
    with full-rank neighbourhoods both agree to float32 level.
The generator test is the pure route of both packages: the JAX generator
pinned with GCSLAM_NO_NATIVE=1, the port's with native=False. The native
route (the default of both) is held in tests/test_torch_native.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.frontend import camera as jc, synthetic as jsyn
from gcslam_tpu.models import atlas as jatlas, scan_step as jstep
from gcslam_tpu.models.belief import Belief as JBelief, world_pose as jworld_pose
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.ops import association as jassoc, evidence_pose as jpose, iw as jiw, tiling as jtiling
from gcslam_torch.frontend import camera as tc, synthetic as tsyn
from gcslam_torch.models import atlas as tatlas, runner as trunner, scan_step as tstep
from gcslam_torch.models.batch import MeasurementBatch
from gcslam_torch.models.belief import Belief, world_pose as tworld_pose
from gcslam_torch.models.config import PipelineConfig as TConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import association as tassoc, evidence_pose as tpose, tiling as ttiling

H, W, N_FEAT = 120, 160, 512
JINTR = jc.PinholeIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0)
TINTR = tc.PinholeIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0)
SMALL_CAM = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
                 surfel_voxel_size_m=0.5, with_camera=True)
N_SCANS = 4  # the world's scans; the fourth is the shared-state step


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def T(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def close(j, t, rtol, atol):
    np.testing.assert_allclose(t.detach().double().numpy(), np.asarray(j).astype(np.float64),
                               rtol=rtol, atol=atol)


def rel_to_max(j, t):
    j = np.asarray(j, dtype=np.float64)
    return np.abs(np.asarray(t, dtype=np.float64) - j).max() / max(np.abs(j).max(), 1e-300)


def smooth_scene(seed, n_lidar=2048):
    """Smooth random texture (no two corner responses within rounding), a
    sloped depth image with holes, random colours, and a LiDAR cloud with
    full-rank neighbourhoods in front of the camera."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(float)
    gray = np.zeros((H, W))
    for _ in range(12):
        fx, fy, ph = rng.uniform(0.05, 0.35), rng.uniform(0.05, 0.35), rng.uniform(0, 6.3)
        gray += rng.uniform(0.2, 1) * np.sin(fx * xx + ph) * np.cos(fy * yy + 2 * ph)
    gray = (gray - gray.min()) / (gray.max() - gray.min())
    depth = 2.0 + 0.03 * rng.uniform(size=(H, W)) + 0.02 * xx
    depth[rng.uniform(size=(H, W)) < 0.05] = 0.0
    rgb = rng.uniform(size=(H, W, 3))
    lidar = np.stack([rng.uniform(-3, 3, n_lidar), rng.uniform(-2, 2, n_lidar), rng.uniform(1, 8, n_lidar)], 1)
    return gray, depth, rgb, lidar, rng.uniform(0.1, 1.0, n_lidar)


# ---------------------------------------------------------------------------
# frontend/camera.py, function by function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_harris_corners_match(seed):
    gray = smooth_scene(seed)[0]
    uj, sj, vj = [np.asarray(x) for x in jc.harris_corners(jnp.asarray(gray), N_FEAT)]
    ut, st, vt = tc.harris_corners(torch.as_tensor(gray), N_FEAT)
    assert vj.sum() > 100
    assert np.array_equal(uj, ut.numpy()) and np.array_equal(vj, vt.numpy())
    assert ut.dtype == torch.float32 and st.dtype == torch.float32
    # f32 filter sums in another order: ~1e-6 of the largest response
    assert rel_to_max(sj, st.numpy()) < 1e-5


def test_harris_corner_sets_on_the_checker_world():
    """On the generator's own frames (checker plateaus) the corner sets
    agree on >= 90 % of the corners (measured 94-98 % along the 50-scan
    path); the rest are plateau ties broken by rounding."""
    cfg = jsyn.SyntheticConfig(with_camera=True, n_scans=50)
    traj = jsyn.build_trajectory(cfg)
    for k in (0, 21, 49):
        pos, yaw, _, _, _ = traj((k + 1) * 0.1)
        gray = jsyn._render_rgbd(pos, yaw, cfg)[0]
        assert np.array_equal(gray, tsyn._render_rgbd(pos, yaw, cfg)[0])
        uj, _, vj = [np.asarray(x) for x in jc.harris_corners(jnp.asarray(gray), N_FEAT)]
        ut, _, vt = [x.numpy() for x in tc.harris_corners(torch.as_tensor(gray), N_FEAT)]
        a, b = set(map(tuple, uj[vj])), set(map(tuple, ut[vt]))
        assert len(a & b) >= 0.9 * max(len(a), len(b)), (k, len(a), len(b), len(a & b))


def test_gather_patch_and_depth_plane_fit():
    """float64 depth (as the generator passes it): the same sums in another
    order, to 1e-9 of each field's largest value."""
    gray, depth, *_ = smooth_scene(2)
    uv = np.array(jc.harris_corners(jnp.asarray(gray), N_FEAT)[0])
    uv[:5] = [[0, 0], [W - 1, H - 1], [1, H - 2], [W - 2, 3], [80, 60]]  # clamped borders
    assert np.array_equal(np.asarray(jc._gather_patch(jnp.asarray(depth), jnp.asarray(uv), 2)),
                          tc._gather_patch(torch.as_tensor(depth), torch.as_tensor(uv), 2).numpy())
    for j, t in zip(jc.depth_plane_fit(jnp.asarray(depth), jnp.asarray(uv)),
                    tc.depth_plane_fit(torch.as_tensor(depth), torch.as_tensor(uv))):
        assert rel_to_max(j, t.numpy()) < 1e-9


def test_backprojection():
    rng = np.random.default_rng(3)
    uv = rng.uniform(0, 160, (64, 2)).astype(np.float32)
    z, s2 = rng.uniform(0.5, 9.0, 64), rng.uniform(1e-4, 1e-1, 64)
    close(jc.backprojection_covariance(jnp.asarray(uv), jnp.asarray(z), jnp.asarray(s2), JINTR),
          tc.backprojection_covariance(T(uv), T(z), T(s2), TINTR), rtol=1e-12, atol=0)
    close(jc.backproject(jnp.asarray(uv), jnp.asarray(z), JINTR), tc.backproject(T(uv), T(z), TINTR),
          rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_lidar_depth_evidence(seed):
    """float32 (512 x 2048) weights, matrix products and a float32 Jacobi
    eigensolve on full-rank neighbourhoods: ~1e-5 of each field's max."""
    gray, _, _, lidar, w = smooth_scene(seed)
    uv = np.asarray(jc.harris_corners(jnp.asarray(gray), N_FEAT)[0])
    f32 = np.float32
    lj, zj = jc.lidar_depth_evidence(jnp.asarray(uv), jnp.asarray(lidar.astype(f32)), jnp.asarray(w.astype(f32)), JINTR)
    lt, zt = tc.lidar_depth_evidence(T(uv), T(lidar.astype(f32)), T(w.astype(f32)), TINTR)
    assert lt.dtype == torch.float32
    assert rel_to_max(lj, lt.numpy()) < 1e-4 and rel_to_max(zj, zt.numpy()) < 1e-4


@pytest.mark.parametrize("seed", [0, 3])
def test_extract_camera_features(seed):
    gray, depth, rgb, lidar, w = smooth_scene(seed)
    fj = jc.extract_camera_features(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(rgb), JINTR,
                                    jnp.asarray(lidar), jnp.asarray(w))
    ft = tc.extract_camera_features(T(gray), T(depth), T(rgb), TINTR, T(lidar), T(w))
    for f in fj._fields:
        j, t = np.asarray(getattr(fj, f)), getattr(ft, f).numpy()
        assert j.dtype == t.dtype, f
        if f in ("uv", "colors", "valid"):
            assert np.array_equal(j, t), f
        else:  # the f32 LiDAR evidence sets the floor (measured <= 1.4e-5)
            assert rel_to_max(j, t) < 1e-4, f
    # no LiDAR: camera depth only
    fj0 = jc.extract_camera_features(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(rgb), JINTR)
    ft0 = tc.extract_camera_features(T(gray), T(depth), T(rgb), TINTR)
    for f in fj0._fields:
        assert rel_to_max(np.asarray(getattr(fj0, f)), getattr(ft0, f).numpy()) < 1e-6, f


def test_features_to_base_frame():
    gray, depth, rgb, lidar, w = smooth_scene(1)
    fj = jc.extract_camera_features(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(rgb), JINTR,
                                    jnp.asarray(lidar), jnp.asarray(w))
    ft = tc.CameraFeatures(*[T(x) for x in np_tree(fj)])
    bj = jc.features_to_base_frame(fj, jnp.asarray(jsyn._t_base_cam()))
    bt = tc.features_to_base_frame(ft, tsyn.T_BASE_CAM)
    np.testing.assert_array_equal(jsyn._t_base_cam(), tsyn.T_BASE_CAM)
    for f in ("Lambdas", "thetas", "etas"):
        assert rel_to_max(getattr(bj, f), getattr(bt, f).numpy()) < 1e-10, f


# ---------------------------------------------------------------------------
# The generator's camera branch and the map code camera rows reach
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jrun():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GCSLAM_NO_NATIVE", "1")
        return jsyn.generate(jsyn.SyntheticConfig(n_scans=N_SCANS, n_points=512, with_camera=True))


def test_generate_with_camera(jrun, monkeypatch):
    """Given the reference's corners (see the module note), the port's
    generator fills the camera slice as the JAX one does; the LiDAR, IMU
    and odometry fields are bit-equal."""
    def jax_corners(gray, n_feat, **kw):
        return tuple(torch.as_tensor(np.array(x))
                     for x in jc.harris_corners(jnp.asarray(gray.cpu().numpy()), n_feat, **kw))

    monkeypatch.setattr(tc, "harris_corners", jax_corners)
    mine = tsyn.generate(tsyn.SyntheticConfig(n_scans=N_SCANS, n_points=512, with_camera=True), device="cpu",
                         native=False)
    np.testing.assert_array_equal(mine.gt_poses, jrun.gt_poses)
    for jb, tb in zip(jrun.batches, mine.batches):
        for f in tb._fields:
            j, t = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
            assert j.dtype == t.dtype, f
            if not f.startswith("cam_") or f in ("cam_valid", "cam_colors"):
                assert np.array_equal(j, t), f
        v = np.asarray(jb.cam_valid)
        assert v.sum() > 200
        # lobes and weights see only corner scores and ray directions
        for f in ("cam_etas", "cam_weights"):
            assert rel_to_max(getattr(jb, f), getattr(tb, f).numpy()) < 1e-6, f
        # Gaussians: the f32 Route-B precision follows rounding on
        # rank-deficient LiDAR neighbourhoods (512 points per scan leave
        # most features 0-2 neighbours); the typical row agrees to ~3e-5
        Lj, Lt = np.asarray(jb.cam_Lambdas)[v], tb.cam_Lambdas.numpy()[v]
        row = np.abs(Lj - Lt).max((1, 2)) / np.abs(Lj).max((1, 2))
        assert np.median(row) < 1e-4


@pytest.fixture(scope="module")
def world(jrun):
    """The port runs three camera-on scans of the JAX batches; its state
    goes to the JAX package; both compute the fourth scan's map pieces."""
    jcfg, tcfg = JConfig(**SMALL_CAM), TConfig(**SMALL_CAM)
    tbatches = [batch_from_numpy(np_tree(b), device="cpu") for b in jrun.batches]
    ts, _ = trunner.run_bag(tbatches[:N_SCANS - 1], tcfg, device="cpu")
    ns = tstep.state_to_numpy(ts)
    js = jstep.StepState(
        beliefs=JBelief(*ns.beliefs), hyp_weights=ns.hyp_weights,
        process_iw=jiw.ProcessNoiseIW(*ns.process_iw), meas_iw=jiw.MeasurementNoiseIW(*ns.meas_iw),
        atlas=jatlas.AtlasState(*ns.atlas), scan_count=ns.scan_count)
    js = jax.tree_util.tree_map(jnp.asarray, js)
    jb, tb = jrun.batches[-1], tbatches[-1]

    @jax.jit
    def jax_prelude(state, batch):
        b0 = jax.tree_util.tree_map(lambda x: x[0], state.beliefs)
        ids = jtiling.stencil_tile_ids(jworld_pose(b0)[:3], 1, 0, jcfg.h_tile)
        a, slots = jatlas.allocate_tiles(state.atlas, ids, batch.scan_seq)
        a, _ = jatlas.recency_inflate(a, slots, batch.scan_seq, jcfg)
        view = jatlas.extract_view(a, slots, jnp.ones_like(slots, dtype=bool), jcfg)
        sensor_var = jnp.trace(jiw.measurement_noise_mode(state.meas_iw, 2)) / 3.0
        (mb, sl, _), z = jstep._shared_extraction_inputs(b0, batch, view, jcfg, sensor_var)
        return ids, a, slots, view, mb, sl, z

    jids, ja, jslots, jview, jmb, jsl, jz = jax_prelude(js, jb)
    tb0 = Belief(*[x[0] for x in ts.beliefs])
    tids = ttiling.stencil_tile_ids(tworld_pose(tb0)[:3], 1, 0, tcfg.h_tile)
    ta, tslots = tatlas.allocate_tiles(ts.atlas, tids, tb.scan_seq)
    ta, _ = tatlas.recency_inflate(ta, tslots, tb.scan_seq, tcfg)
    tview = tatlas.extract_view(ta, tslots, torch.ones_like(tslots, dtype=torch.bool), tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jb=jb, tb=tb, ja=ja, jslots=jslots, jids=jids, jview=jview, ta=ta,
                tslots=tslots, tids=tids, tview=tview, jmb=jmb, jsl=jsl, jz=jz)


def test_camera_rows_reach_the_map(world):
    """The measurement batch carries the camera rows first, and the atlas
    after three camera-on scans holds camera mass and colour."""
    mb = world["jmb"]
    n_cam = int(np.sum(np.asarray(mb.sources) == 0))
    assert n_cam == N_FEAT and int(np.sum(np.asarray(mb.valid)[:n_cam])) > 200
    assert float(world["ta"].cam_mass.sum()) > 0
    assert bool(((world["ta"].rgb != 0.5).any(-1) & world["ta"].valid).any())


def test_association_and_pose_factor_with_camera_rows(world):
    """Same measurement batch (camera + surfel rows), view and pose in both:
    the camera-row branches of the association and the pose factor
    (modality weighting against lidar-dominant slots, rotation scatter from
    surfels only) agree as the LiDAR-only rows do."""
    p, jcfg, tcfg = world, world["jcfg"], world["tcfg"]
    tmb = MeasurementBatch(*[T(x) for x in p["jmb"]])
    z = T(p["jz"])
    R = tstep.se3.so3_exp(z[3:6])
    mpos_w = tstep.atlas_mod.mean_positions(tmb, tcfg.eps_lift) @ R.T + z[None, :3]
    sl = tassoc.shortlist_candidates(mpos_w, tmb.valid, p["tview"], tcfg)
    assert np.array_equal(np.asarray(p["jsl"].idx), sl.numpy())
    tsl = tassoc.gather_candidates(p["tview"], sl)
    for anneal in (8.0, 1.0):
        jcfg_r = dataclasses.replace(jcfg, ot_epsilon=jcfg.ot_epsilon * jnp.asarray(anneal),
                                     pose_cauchy_r0_m=jcfg.pose_cauchy_r0_m * jnp.sqrt(anneal))
        ja, jcert = jassoc.associate_primitives_ot(p["jmb"], p["jview"], p["jb"].scan_seq, jcfg_r, p["jz"],
                                                   shortlist=p["jsl"])
        ta, tcert = tassoc.associate_primitives_ot(tmb, p["tview"], p["tb"].scan_seq, tcfg, z, tsl,
                                                   tcfg.ot_epsilon * anneal)
        assert np.array_equal(np.asarray(ja.cand_pool), ta.cand_pool.numpy())
        # f32 costs of camera rows carry their ~1e6 precisions: 1e-4 relative
        jcost = np.asarray(ja.cost)
        fin = np.isfinite(jcost)
        assert np.array_equal(fin, np.isfinite(ta.cost.numpy()))
        close(jcost[fin], ta.cost[torch.as_tensor(fin)], rtol=1e-4, atol=0)
        for f in ("responsibilities", "row_masses"):
            close(getattr(ja, f), getattr(ta, f), rtol=0, atol=1e-5)
        for f in ("transport_mass", "marginal_defect_a", "ess_ot"):
            close(getattr(ja, f), getattr(ta, f), rtol=1e-5, atol=0)
        assert int(jcert.triggers) == int(tcert.triggers)
        jL, jh, _ = jpose.primitive_pose_evidence(ja, p["jmb"], p["jview"], p["jz"], jcfg_r, cands=p["jsl"])
        tL, th, _ = tpose.primitive_pose_evidence(ta, tmb, z, tcfg, tsl, tcfg.pose_cauchy_r0_m * anneal ** 0.5)
        assert rel_to_max(jL, tL.numpy()) < 1e-5 and rel_to_max(jh, th.numpy()) < 1e-5


@pytest.mark.parametrize("modality", [dict(), dict(pose_modality_mode="matched"),
                                      dict(pose_camera_weight=0.25, pose_rot_scatter_surfels_only=False)])
def test_pose_factor_camera_options(world, modality):
    """The camera options of the pose factor on one association."""
    p = world
    jcfg, tcfg = (dataclasses.replace(c, **modality) for c in (p["jcfg"], p["tcfg"]))
    tmb = MeasurementBatch(*[T(x) for x in p["jmb"]])
    tsl = tassoc.gather_candidates(p["tview"], T(np.asarray(p["jsl"].idx)).long())
    ja, _ = jassoc.associate_primitives_ot(p["jmb"], p["jview"], p["jb"].scan_seq, jcfg, p["jz"], shortlist=p["jsl"])
    ta, _ = tassoc.associate_primitives_ot(tmb, p["tview"], p["tb"].scan_seq, tcfg, T(p["jz"]), tsl, tcfg.ot_epsilon)
    jL, jh, _ = jpose.primitive_pose_evidence(ja, p["jmb"], p["jview"], p["jz"], jcfg, cands=p["jsl"])
    tL, th, _ = tpose.primitive_pose_evidence(ta, tmb, T(p["jz"]), tcfg, tsl, tcfg.pose_cauchy_r0_m)
    assert rel_to_max(jL, tL.numpy()) < 1e-5 and rel_to_max(jh, th.numpy()) < 1e-5


def test_map_update_with_camera_rows(world):
    """GN evidence from the JAX side, then one map_update_step in both: the
    camera-mass, colour-accumulator and colour channels of fuse and insert."""
    p, jcfg, tcfg, jb = world, world["jcfg"], world["tcfg"], world["jb"]
    _, _, _, jext = jatlas.map_gn_evidence(p["jmb"], p["jsl"], None, p["jview"], jb.scan_seq, p["jz"], jcfg)
    text = tatlas.MapExtras(
        batch=MeasurementBatch(*[T(x) for x in jext.batch]),
        **{f: T(getattr(jext, f)) for f in tatlas.MapExtras._fields if f != "batch"})
    text = text._replace(cand_pool=text.cand_pool.long())
    z_t = np.asarray(p["jz"]) + np.array([0.01, -0.02, 0.0, 0.0, 0.0, 0.003])
    ja, jtape = jatlas.map_update_step(p["ja"], p["jview"], jext, jnp.asarray(z_t), p["jslots"], p["jids"],
                                       jb.scan_seq, jb.scan_end_time, jcfg)
    ta, ttape = tatlas.map_update_step(p["ta"], p["tview"], text, T(z_t), p["tslots"], p["tids"],
                                       p["tb"].scan_seq, p["tb"].scan_end_time, tcfg)
    assert float(np.asarray(jtape["fused_mass"])) > 0
    for f in jatlas.AtlasState._fields:
        j, t = np.asarray(getattr(ja, f)), getattr(ta, f)
        if j.dtype.kind in "biu":
            assert np.array_equal(j, t.numpy()), f
        else:  # f32 channels: same terms, same serial summation order
            close(j, t, rtol=1e-6, atol=1e-9)
    for k in jtape:
        close(jtape[k], ttape[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("stage", ["fuse", "insert", "merge"])
def test_slab_stages_with_camera_rows(stage):
    """Fuse, insert and merge on a crafted slab that carries camera mass and
    colour, with a half-camera measurement batch."""
    import test_torch_map as tm

    A, M = 3, 32
    over = dict(SMALL_CAM, m_tile=M, m_tile_view=M, k_insert_tile=4)
    jcfg, tcfg = JConfig(**over), TConfig(**over)
    slab, batch, extras, view = tm._crafted(2, A=A, M=M)
    rng = np.random.default_rng(7)
    slab["cam_mass"] = (rng.uniform(0, 2, (A, M)) * (rng.uniform(size=(A, M)) < 0.5)).astype(np.float32)
    slab["rgb_accum"] = (slab["cam_mass"][..., None] * rng.uniform(0, 1, (A, M, 3))).astype(np.float32)
    slab["rgb_denom"] = slab["cam_mass"].copy()
    slab["rgb"] = np.where(slab["cam_mass"][..., None] > 0, slab["rgb_accum"] / np.maximum(
        slab["rgb_denom"][..., None], 1e-12), 0.5).astype(np.float32)
    n = batch["sources"].shape[0]
    batch["sources"] = (np.arange(n) % 2).astype(np.int32)  # camera rows first-ish
    batch["colors"] = rng.uniform(0, 1, (n, 3))
    view["lidar_frac"] = rng.uniform(0, 1, A * M)
    jslab = jatlas._Slab(**{k: jnp.asarray(v) for k, v in slab.items()})
    tslab = tatlas._Slab(**{k: T(v) for k, v in slab.items()})
    jbt = jatlas.MeasurementBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    tbt = MeasurementBatch(**{k: T(v) for k, v in batch.items()})
    jext = jatlas.MapExtras(batch=jbt, **{k: jnp.asarray(v) for k, v in extras.items() if k != "batch"})
    text = tatlas.MapExtras(batch=tbt, **{k: T(v) for k, v in extras.items() if k != "batch"})
    jview = jatlas.AtlasView(**{k: jnp.asarray(v) for k, v in view.items()})
    tview = tatlas.AtlasView(**{k: T(v) for k, v in view.items()})
    R, t = np.eye(3), np.array([0.05, -0.02, 0.0])
    jw = jatlas._transform_to_world(jbt.Lambdas, jbt.thetas, jbt.etas, jnp.asarray(R), jnp.asarray(t), 1e-9)
    tw = tatlas._transform_to_world(tbt.Lambdas, tbt.thetas, tbt.etas, T(R), T(t), 1e-9)
    seq, stamp = np.asarray(6, np.int32), np.asarray(0.7)
    if stage == "fuse":
        jo, jm = jatlas._fuse_slab(jslab, jview, jext, *jw[:3], jnp.asarray(seq), jnp.asarray(stamp), jcfg)
        to, tmass = tatlas._fuse_slab(tslab, tview, text, *tw[:3], T(seq), T(stamp), tcfg)
        extra = [(jm, tmass)]
    elif stage == "insert":
        ids = jtiling.tile_ids_from_xyz(jw[3], jcfg.h_tile)
        uniq = np.unique(np.asarray(ids))[:A]
        active = jnp.asarray(uniq.tolist() + [0] * (A - len(uniq)))
        jo, jn, jm, je, jev = jatlas._insert_slab(jslab, jnp.asarray(5, jnp.int32), jext, jw[3], *jw[:3], active,
                                                  jnp.asarray(seq), jnp.asarray(stamp), jcfg)
        to, tn, tmass, te, tev = tatlas._insert_slab(tslab, torch.tensor(5, dtype=torch.int32), text, tw[3],
                                                     *tw[:3], T(active), T(seq), T(stamp), tcfg)
        assert int(jn) > 5
        extra = [(jn, tn), (jm, tmass), (je, te)] + [(jev[k], tev[k]) for k in jev]
    else:
        jo, jn = jatlas._merge_reduce_slab(jslab, jcfg)
        to, tn = tatlas._merge_reduce_slab(tslab, tcfg)
        assert int(jn) > 0
        extra = [(jn, tn)]
    assert float(np.asarray(jo.cam_mass).sum()) > 0
    for f in jatlas._Slab._fields:
        j, tt = np.asarray(getattr(jo, f)), getattr(to, f)
        if j.dtype.kind in "biu":
            assert np.array_equal(j, tt.numpy()), f
        else:
            close(j, tt, rtol=1e-5, atol=1e-6)
    for j, tt in extra:
        close(j, tt, rtol=1e-5, atol=1e-6)
