"""The port's map branch against the JAX package's at the SMALL budgets of
tests/test_pipeline.py, from one shared atlas state: the port runs three
scans, its state goes to the JAX package (state_to_numpy), and both compute
the fourth scan's map pieces from identical inputs.

Where a tolerance is loose, it is because the reference computes in f32 on
purpose: surfel moments accumulate in float32, and a near-planar cell's
covariance m2/m0 - c c^T cancels ~1e3-1e6 of its magnitude, so a one-ulp
change of the cloud centroid (a reduction order) moves a surfel precision
by up to ~1e-3 relative."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models import atlas as jatlas, scan_step as jstep
from gcslam_tpu.models.belief import Belief as JBelief, world_pose as jworld_pose
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.ops import association as jassoc, evidence_pose as jpose, iw as jiw, surfels as jsurf
from gcslam_tpu.ops import tiling as jtiling
from gcslam_torch.models import atlas as tatlas, runner as trunner, scan_step as tstep
from gcslam_torch.models.batch import MeasurementBatch
from gcslam_torch.models.belief import Belief, world_pose as tworld_pose
from gcslam_torch.models.config import PipelineConfig as TConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import association as tassoc, evidence_pose as tpose, surfels as tsurf
from gcslam_torch.ops import tiling as ttiling

SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
             surfel_voxel_size_m=0.5)
SCAN = 3


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def T(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def close(j, t, rtol, atol):
    np.testing.assert_allclose(t.detach().double().numpy(), np.asarray(j).astype(np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def world():
    run = jgenerate(JSynth(n_scans=10, n_points=512))
    jcfg, tcfg = JConfig(**SMALL), TConfig(**SMALL)
    tbatches = [batch_from_numpy(np_tree(b), device="cpu") for b in run.batches[:SCAN + 1]]
    ts, _ = trunner.run_bag(tbatches[:SCAN], tcfg, device="cpu")
    ns = tstep.state_to_numpy(ts)
    js = jstep.StepState(
        beliefs=JBelief(*ns.beliefs), hyp_weights=ns.hyp_weights,
        process_iw=jiw.ProcessNoiseIW(*ns.process_iw), meas_iw=jiw.MeasurementNoiseIW(*ns.meas_iw),
        atlas=jatlas.AtlasState(*ns.atlas), scan_count=ns.scan_count)
    return dict(run=run, jcfg=jcfg, tcfg=tcfg, jstate=jax.tree_util.tree_map(jnp.asarray, js), tstate=ts,
                jbatch=run.batches[SCAN], tbatch=tbatches[SCAN])


@pytest.fixture(scope="module")
def prelude(world):
    """Tile allocation, recency inflation and view extraction in both."""
    jcfg, tcfg, jb, tb = world["jcfg"], world["tcfg"], world["jbatch"], world["tbatch"]

    @jax.jit
    def jax_prelude(state, batch):  # one compile instead of op-by-op dispatch
        b0 = jax.tree_util.tree_map(lambda x: x[0], state.beliefs)
        ids = jtiling.stencil_tile_ids(jworld_pose(b0)[:3], 1, 0, jcfg.h_tile)
        a, slots = jatlas.allocate_tiles(state.atlas, ids, batch.scan_seq)
        a, _ = jatlas.recency_inflate(a, slots, batch.scan_seq, jcfg)
        view = jatlas.extract_view(a, slots, jnp.ones_like(slots, dtype=bool), jcfg)
        sensor_var = jnp.trace(jiw.measurement_noise_mode(state.meas_iw, 2)) / 3.0
        (mb, sl, _), z = jstep._shared_extraction_inputs(b0, batch, view, jcfg, sensor_var)
        return ids, a, slots, view, mb, sl, z

    jids, ja, jslots, jview, jmb, jsl, jz = jax_prelude(world["jstate"], jb)
    tb0 = Belief(*[x[0] for x in world["tstate"].beliefs])
    tids = ttiling.stencil_tile_ids(tworld_pose(tb0)[:3], 1, 0, tcfg.h_tile)
    ta, tslots = tatlas.allocate_tiles(world["tstate"].atlas, tids, tb.scan_seq)
    ta, _ = tatlas.recency_inflate(ta, tslots, tb.scan_seq, tcfg)
    tview = tatlas.extract_view(ta, tslots, torch.ones_like(tslots, dtype=torch.bool), tcfg)
    return dict(ja=ja, jslots=jslots, jids=jids, jview=jview, ta=ta, tslots=tslots, tids=tids,
                tview=tview, jmb=jmb, jsl=jsl, jz=jz)


def test_tile_allocation_and_view_match(prelude):
    p = prelude
    assert np.array_equal(np.asarray(p["jids"]), p["tids"].numpy())
    assert np.array_equal(np.asarray(p["jslots"]), p["tslots"].numpy())
    for f in jatlas.AtlasState._fields:  # same f32/int ops on the same data: exact
        assert np.array_equal(np.asarray(getattr(p["ja"], f)), getattr(p["ta"], f).numpy()), f
    for f in jatlas.AtlasView._fields:
        close(getattr(p["jview"], f), getattr(p["tview"], f), rtol=1e-12, atol=0)
    queries = np.concatenate([np.asarray(p["jids"])[::2], [12345]])  # hits and a miss
    js, jf = jatlas.lookup_tiles(p["ja"], jnp.asarray(queries))
    ts, tf = tatlas.lookup_tiles(p["ta"], T(queries))
    assert np.array_equal(np.asarray(js), ts.numpy()) and np.array_equal(np.asarray(jf), tf.numpy())


def _cloud(seed):
    """Three noisy planes and their mirror images on a 1/64 m lattice, unit
    weights and dyadic stamps: every f32 moment sum is exact (the centroid is
    exactly 0 and each cell sums < 2^24 lattice units), so both sides see the
    same moments whatever their summation order."""
    rng = np.random.default_rng(seed)
    n = 512
    u, v = rng.integers(-96, 97, n), rng.integers(-96, 97, n)
    off = rng.integers(-2, 3, n)
    plane = rng.integers(0, 3, n)
    pts = np.where(plane[:, None] == 0, np.stack([u, v, -64 + off], 1),
                   np.where(plane[:, None] == 1, np.stack([u, 128 + off, v], 1),
                            np.stack([-128 + off, u, v], 1)))
    pts = np.concatenate([pts, -pts]) / 64.0
    stamps = 100.0 + rng.integers(0, 100, 2 * n) / 1024.0
    return pts.astype(np.float32), stamps, np.ones(2 * n, np.float32)


def test_surfels_match_on_exact_moments():
    pts, stamps, w = _cloud(0)
    js, jc = jsurf.extract_surfels(jnp.asarray(pts), jnp.asarray(stamps), jnp.asarray(w), 64, 0.5, 3)
    ts, tc = tsurf.extract_surfels(T(pts), T(stamps), T(w), 64, 0.5, 3)
    assert np.array_equal(np.asarray(js.valid), ts.valid.numpy())
    assert int(js.n_valid) == int(ts.n_valid) > 20
    for f in ("positions", "Lambdas", "normals", "kappas", "weights", "timestamps"):
        close(getattr(js, f), getattr(ts, f), rtol=1e-9, atol=1e-9)
    assert int(jc.triggers) == int(tc.triggers)


def test_shortlist_and_association_from_shared_inputs(world, prelude):
    """Same measurement batch, view and pose into both: the shortlist is the
    same set of pool rows and every GN round's association agrees."""
    p, jcfg, tcfg = prelude, world["jcfg"], world["tcfg"]
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
        ja, jcert = jassoc.associate_primitives_ot(p["jmb"], p["jview"], world["jbatch"].scan_seq,
                                                   jcfg_r, p["jz"], shortlist=p["jsl"])
        ta, tcert = tassoc.associate_primitives_ot(tmb, p["tview"], world["tbatch"].scan_seq, tcfg, z,
                                                   tsl, tcfg.ot_epsilon * anneal)
        assert np.array_equal(np.asarray(ja.cand_pool), ta.cand_pool.numpy())
        # f32 costs (1e-7) pass through exp(-C/eps) with C/eps up to ~1e2
        close(ja.cost, ta.cost, rtol=1e-5, atol=0)
        for f in ("responsibilities", "row_masses"):
            close(getattr(ja, f), getattr(ta, f), rtol=0, atol=1e-7)
        for f in ("transport_mass", "marginal_defect_a", "ess_ot"):
            close(getattr(ja, f), getattr(ta, f), rtol=1e-6, atol=0)
        assert int(jcert.triggers) == int(tcert.triggers)

        jL, jh, _ = jpose.primitive_pose_evidence(ja, p["jmb"], p["jview"], p["jz"], jcfg_r, cands=p["jsl"])
        tL, th, _ = tpose.primitive_pose_evidence(ta, tmb, z, tcfg, tsl, tcfg.pose_cauchy_r0_m * anneal ** 0.5)
        close(jL, tL, rtol=1e-5, atol=1e-6)
        close(jh[:3], th[:3], rtol=1e-5, atol=1e-8)
        jrot = np.asarray(jh[3:6])
        if anneal > 1.0:
            close(jrot, th[3:6], rtol=1e-5, atol=1e-8)
        else:
            # On the tight final round this scan's normal scatter is near
            # rank one (floor-dominated, few matches): the rotation about
            # its dominant normal is a near-tie that each side breaks at
            # rounding level, and the residual's weak components move with
            # it. Only the size of the rotation pull is held.
            close(jrot, th[3:6], rtol=0, atol=0.5 * np.abs(jrot).max())


def test_map_update_step_from_shared_state(world, prelude):
    """GN evidence from the JAX side, then one map_update_step in both."""
    p, jcfg, tcfg = prelude, world["jcfg"], world["tcfg"]
    jb = world["jbatch"]
    _, _, _, jext = jatlas.map_gn_evidence(p["jmb"], p["jsl"], None, p["jview"], jb.scan_seq, p["jz"], jcfg)
    text = tatlas.MapExtras(
        batch=MeasurementBatch(*[T(x) for x in jext.batch]),
        **{f: T(getattr(jext, f)) for f in tatlas.MapExtras._fields if f != "batch"})
    text = text._replace(cand_pool=text.cand_pool.long())
    z_t = np.asarray(p["jz"]) + np.array([0.01, -0.02, 0.0, 0.0, 0.0, 0.003])
    ja, jtape = jatlas.map_update_step(p["ja"], p["jview"], jext, jnp.asarray(z_t), p["jslots"], p["jids"],
                                       jb.scan_seq, jb.scan_end_time, jcfg)
    ta, ttape = tatlas.map_update_step(p["ta"], p["tview"], text, T(z_t), p["tslots"], p["tids"],
                                       world["tbatch"].scan_seq, world["tbatch"].scan_end_time, tcfg)
    for f in jatlas.AtlasState._fields:
        j, t = np.asarray(getattr(ja, f)), getattr(ta, f)
        if j.dtype.kind in "biu":
            assert np.array_equal(j, t.numpy()), f
        else:  # f32 channels: same terms, same serial summation order
            close(j, t, rtol=1e-6, atol=0)
    for k in jtape:
        close(jtape[k], ttape[k], rtol=1e-6, atol=0)


def _crafted(seed, A=3, M=32, N=24, K=8):
    """A slab with near-duplicate primitives (merge-eligible pairs), mostly
    full tiles (eviction on insert), a few near-dead slots (cull), and a
    measurement batch whose pairs land on it."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-1, 1, size=(A, M, 3))
    mu[:, 1::2] = mu[:, 0::2] + rng.normal(0, 0.005, size=(A, M // 2, 3))  # twins
    lam = rng.uniform(50, 200, size=(A, M))[..., None, None] * np.eye(3)
    slab = dict(
        Lambdas=lam, thetas=np.einsum("amij,amj->ami", lam, mu),
        etas=rng.normal(size=(A, M, 3, 3)), weights=rng.uniform(0.5, 3.0, size=(A, M)),
        valid=rng.uniform(size=(A, M)) < 0.97, timestamps=rng.uniform(0, 1, size=(A, M)),
        created=rng.uniform(0, 1, size=(A, M)), last_supported=rng.integers(0, 5, size=(A, M)),
        last_update=rng.integers(0, 5, size=(A, M)), primitive_ids=rng.integers(0, 100, size=(A, M)),
        cam_mass=np.zeros((A, M)), lidar_mass=rng.uniform(0.5, 3.0, size=(A, M)),
        rgb_accum=np.zeros((A, M, 3)), rgb_denom=np.zeros((A, M)), rgb=np.full((A, M, 3), 0.5))
    slab["weights"][:, :2] = 1e-6  # cull candidates
    f32 = {"Lambdas", "thetas", "etas", "weights", "cam_mass", "lidar_mass", "rgb_accum", "rgb_denom", "rgb"}
    slab = {k: (v.astype(np.float32) if k in f32 else v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in slab.items()}
    meas_mu = rng.uniform(-1, 1, size=(N, 3))
    Lb = rng.uniform(50, 200, size=N)[:, None, None] * np.eye(3)
    batch = dict(Lambdas=Lb, thetas=np.einsum("nij,nj->ni", Lb, meas_mu), etas=rng.normal(size=(N, 3, 3)),
                 weights=rng.uniform(0.5, 2.0, N), sources=np.ones(N, np.int32), valid=rng.uniform(size=N) < 0.8,
                 timestamps=np.full(N, 0.5), colors=np.full((N, 3), 0.5))
    resp = rng.uniform(0, 0.05, size=(N, K))
    extras = dict(batch=batch, responsibilities=resp, cand_pool=rng.integers(0, A * M, size=(N, K)),
                  row_masses=resp.sum(1) * rng.uniform(0, 0.2, N), ot_transport_mass=np.asarray(resp.sum()),
                  ot_marginal_defect_a=np.asarray(0.1), z_map_pose=np.zeros(6),
                  lidar_residuals=np.zeros((N, K, 3)), lidar_resid_w=np.zeros((N, K)))
    view = dict(positions=np.zeros((A * M, 3)), directions=np.zeros((A * M, 3)), kappas=np.zeros(A * M),
                weights=np.zeros(A * M), valid=rng.uniform(size=A * M) < 0.9,
                primitive_ids=np.zeros(A * M, np.int32), last_supported=np.zeros(A * M, np.int32),
                tile_slot=np.repeat(np.arange(A), M).astype(np.int32),
                slot=np.concatenate([rng.permutation(M) for _ in range(A)]).astype(np.int32),
                lidar_frac=np.ones(A * M))
    return slab, batch, extras, view


@pytest.mark.parametrize("stage", ["fuse", "insert", "cull_forget", "merge"])
def test_slab_stages_on_a_crafted_slab(stage):
    """Each map-update stage of both packages on one crafted slab that
    exercises what a short replay rarely reaches: merges, evictions, culls."""
    A, M = 3, 32
    over = dict(SMALL, m_tile=M, m_tile_view=M, k_insert_tile=4)
    jcfg, tcfg = JConfig(**over), TConfig(**over)
    slab, batch, extras, view = _crafted(1, A=A, M=M)
    jslab = jatlas._Slab(**{k: jnp.asarray(v) for k, v in slab.items()})
    tslab = tatlas._Slab(**{k: T(v) for k, v in slab.items()})
    jb = jatlas.MeasurementBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    tb = MeasurementBatch(**{k: T(v) for k, v in batch.items()})
    jext = jatlas.MapExtras(batch=jb, **{k: jnp.asarray(v) for k, v in extras.items() if k != "batch"})
    text = tatlas.MapExtras(batch=tb, **{k: T(v) for k, v in extras.items() if k != "batch"})
    jview = jatlas.AtlasView(**{k: jnp.asarray(v) for k, v in view.items()})
    tview = tatlas.AtlasView(**{k: T(v) for k, v in view.items()})
    R, t = np.eye(3), np.array([0.05, -0.02, 0.0])
    jw = jatlas._transform_to_world(jb.Lambdas, jb.thetas, jb.etas, jnp.asarray(R), jnp.asarray(t), 1e-9)
    tw = tatlas._transform_to_world(tb.Lambdas, tb.thetas, tb.etas, T(R), T(t), 1e-9)
    seq, stamp = np.asarray(6, np.int32), np.asarray(0.7)
    if stage == "fuse":
        jo, jm = jatlas._fuse_slab(jslab, jview, jext, *jw[:3], jnp.asarray(seq), jnp.asarray(stamp), jcfg)
        to, tm = tatlas._fuse_slab(tslab, tview, text, *tw[:3], T(seq), T(stamp), tcfg)
        extra = [(jm, tm)]
    elif stage == "insert":
        ids = jtiling.tile_ids_from_xyz(jw[3], jcfg.h_tile)
        active = jnp.asarray(np.unique(np.asarray(ids))[:A].tolist() + [0] * (A - len(np.unique(np.asarray(ids)))))
        jo, jn, jm, je, jev = jatlas._insert_slab(jslab, jnp.asarray(5, jnp.int32), jext, jw[3], *jw[:3], active,
                                                  jnp.asarray(seq), jnp.asarray(stamp), jcfg)
        to, tn, tm, te, tev = tatlas._insert_slab(tslab, torch.tensor(5, dtype=torch.int32), text, tw[3], *tw[:3],
                                                  T(active), T(seq), T(stamp), tcfg)
        assert float(je) > 0 and int(jn) > 5  # the crafted slab does evict and insert
        extra = [(jn, tn), (jm, tm), (je, te)] + [(jev[k], tev[k]) for k in jev]
    elif stage == "cull_forget":
        jo, jm, jc = jatlas._cull_forget_slab(jslab, jcfg)
        to, tm, tc = tatlas._cull_forget_slab(tslab, tcfg)
        assert int(jc) > 0
        extra = [(jm, tm), (jc, tc)]
    else:
        jo, jn = jatlas._merge_reduce_slab(jslab, jcfg)
        to, tn = tatlas._merge_reduce_slab(tslab, tcfg)
        assert int(jn) > 0  # the twins do merge
        extra = [(jn, tn)]
    for f in jatlas._Slab._fields:
        j, tt = np.asarray(getattr(jo, f)), getattr(to, f)
        if j.dtype.kind in "biu":
            assert np.array_equal(j, tt.numpy()), f
        else:
            close(j, tt, rtol=1e-5, atol=1e-6)
    for j, tt in extra:
        close(j, tt, rtol=1e-5, atol=1e-6)
