"""The port's per-hypothesis map branch against the JAX package: the
reference's semantics (map_share_extraction=False, map_gn_shared=False:
each hypothesis deskews, extracts its surfels and runs its GN chain) and
the shared-extraction level (one extraction, a GN chain per hypothesis),
plus the unit parity of the 'evidence'-mode IMU operators.

Each option is held to the JAX package twice on
generate(SyntheticConfig(n_scans=10, n_points=512)) at the SMALL budgets of
tests/test_torch_slice.py, both from the JAX state after three scans: one
scan_step, and a 5-scan run_bag (scans 3-7), with test_torch_slice.py's
per-field tolerances (a field that needs another one states why in
OPTION_TOL). The JAX reference is its per-scan jitted step, eight calls
from init_state (one compilation per option). The helpers here serve
tests/test_torch_modes_filter.py and tests/test_torch_modes_assoc.py too.

Why not from init_state: on scan 2 the map holds 5-8 primitives, and the
coarse GN round's factor is near-singular; it turns the f32 point path's
one-ulp differences into steps up to the trust-region cap, in either
package. Measured on this world: per-hypothesis, scan 2's transport mass
is 0.23 in the JAX package and 6e-16 in the port, and poses then differ
by 3.4e-5 m; imu_mode='evidence' 6.6e-5 against 0.30, 8.1e-5 m. From the
state after three scans every option agrees to <= 6.5e-6 m over scans 3-7.

The per-hypothesis GN chains run together in the port: each GN round is
ONE sinkhorn_unbalanced call on C (K_HYP, N, k_assoc)."""

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_tpu.models import runner as jrunner
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_tpu.models.scan_step import init_state as jinit_state
from gcslam_tpu.ops import evidence_imu as jimu, iw as jiw, predict as jpred
from gcslam_torch import constants as C
from gcslam_torch.models import runner, scan_step as tstep
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import association, certs as CT, evidence_imu as timu, predict as tpred
from test_torch_ops import K, T, _beliefs, _vm, near as near_rel
from test_torch_slice import POSE_ATOL, SMALL, compare_tape, near, np_tree

# Fields that need another tolerance than test_torch_slice.TOL under an
# option (rtol of the field's largest magnitude, atol), each from the spread
# measured on this world over both checks, with its reason. "hyp_weights"
# and "beliefs" (L and h) are checked on the state (1e-9 and 1e-5 by
# default).
#
# Per-hypothesis GN chains: each hypothesis' map factor carries the f32
# point path's ~1e-2 spread of its own nll_per_ess (test_torch_slice.TOL),
# and the hypothesis weights follow exp(-gain * nll) per hypothesis (the
# shared chain's equal factors cancel there): hyp_weights 2.7e-5 apart;
# the tempering beta, read off each hypothesis' own evidence, 8.5e-6; the
# barycenter's spread of the hypotheses 1.1e-3.
_PER_HYP_GN = {"hyp_weights": (1e-4, 0), "power_beta": (3e-5, 0), "hyp_spread": (3e-3, 1e-12)}
OPTION_TOL = {
    "per_hypothesis": _PER_HYP_GN,
    "shared_extraction": _PER_HYP_GN,
    # The preintegration factor's position block (1 / (Sigma_a dt^3) ~ 1e8)
    # makes the prediction's information entries large, and its PSD
    # projection delta, a rounding residue, reads 1e-7 (not 1e-10) in both
    # packages, 8e-8 apart.
    "imu_evidence": {"influence_psd_projection_delta": (0, 2e-7)},
    # The odometry target composes the uncertain head pose: poses agree to
    # 6.5e-6 m (of 1e-5), inserted primitives' world positions with the
    # heading over ~2.5 m lever arms to 1.5e-5 m; beta 1.2e-6, spread 2.7e-4.
    "odom_relative": {"map_ins_mu": (0, 3e-5), "power_beta": (3e-6, 0), "hyp_spread": (1e-3, 1e-12)},
    # With the row minimum subtracted every row that keeps one candidate
    # inside the stencil reach (a hard f32 `d < reach` test) has a zero-cost
    # pair, so one surfel at the reach boundary moves its row's whole
    # transport: on scan 5, 24 % of the mass (11 % of the window's largest
    # value; every other scan agrees to 1e-15).
    # The zero-cost pairs also give every matched row full transport, so the
    # map factor sums the f32 surfel spread with full weight: the state's L
    # and h 1.8e-5 apart.
    "row_min": {"beliefs": (5e-5, 0), "ot_transport_mass": (0.3, 1e-3), "map_fused_mass": (0.3, 1e-3),
                "ot_marginal_defect_a": (0.15, 0), "support_ess_total": (0.1, 0),
                "overconfidence_ess_to_excitation": (0.1, 0)},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The SMALL-budget tensors are too small for intra-op threads: one
    thread per test process runs these files faster, and keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    return jgenerate(JSynth(n_scans=10, n_points=512))


@pytest.fixture(scope="module")
def tbatches(run):
    return [batch_from_numpy(np_tree(b), device="cpu") for b in run.batches]


_REFERENCE = {}


def jax_reference(run, overrides):
    """(states after 0..8 scans, the 8 stacked StepOutputs) of the JAX
    package's per-scan step from init_state under `overrides`."""
    key = tuple(sorted(overrides.items()))
    if key not in _REFERENCE:
        jcfg = JConfig(**SMALL, **overrides)
        s = jinit_state(jcfg)
        states, outs = [s], []
        for b in run.batches[:8]:
            s, o = jrunner._step_jit(s, b, jcfg)
            states.append(s)
            outs.append(np_tree(o))
        _REFERENCE[key] = states, jax.tree_util.tree_map(lambda *xs: np.stack(xs), *outs)
    return _REFERENCE[key]


def check_scan_step(run, tbatches, overrides, tol=None):
    """JAX runs three scans; its state goes to the port; both run scan 4."""
    tol = tol or {}
    states, outs = jax_reference(run, overrides)
    ts = tstep.state_from_numpy(np_tree(states[3]), device="cpu")
    t4, tout = tstep.scan_step(ts, tbatches[3], PipelineConfig(**SMALL, **overrides))
    near("pose", outs.pose[3], tout.pose.numpy(), 0, POSE_ATOL)
    compare_tape(jax.tree_util.tree_map(lambda x: x[3:4], outs.tape),
                 tstep.ScanTape(*[x[None] for x in tout.tape]), tol)
    js4, ts4 = np_tree(states[4]), tstep.state_to_numpy(t4)
    near("beliefs.X_anchor", js4.beliefs.X_anchor, ts4.beliefs.X_anchor, 0, POSE_ATOL)
    for f in ("L", "h"):
        near("beliefs." + f, getattr(js4.beliefs, f), getattr(ts4.beliefs, f), *tol.get("beliefs", (1e-5, 0)))
    near("hyp_weights", js4.hyp_weights, ts4.hyp_weights, *tol.get("hyp_weights", (1e-9, 0)))
    if js4.atlas is not None:
        for f in ("valid", "primitive_ids", "tile_ids"):
            assert np.array_equal(getattr(js4.atlas, f), getattr(ts4.atlas, f)), f
        near("atlas.weights", js4.atlas.weights, ts4.atlas.weights, 1e-3, 0)


def check_run_bag(run, tbatches, overrides, tol=None):
    """Scans 3-7 in both packages from the JAX state after three scans."""
    states, outs = jax_reference(run, overrides)
    ts = tstep.state_from_numpy(np_tree(states[3]), device="cpu")
    _, tout = runner.run_bag(tbatches[3:8], PipelineConfig(**SMALL, **overrides), state=ts, device="cpu")
    ref = jax.tree_util.tree_map(lambda x: x[3:8], outs)
    near("pose", ref.pose, tout.pose.numpy(), 0, POSE_ATOL)
    near("stamp", ref.stamp, tout.stamp.numpy(), 0, 0)
    compare_tape(ref.tape, tout.tape, tol)


SHARING = {
    "per_hypothesis": dict(map_share_extraction=False, map_gn_shared=False),
    "shared_extraction": dict(map_share_extraction=True, map_gn_shared=False),
}


@pytest.mark.parametrize("mode", list(SHARING))
def test_scan_step_from_a_shared_state(run, tbatches, mode):
    check_scan_step(run, tbatches, SHARING[mode], OPTION_TOL.get(mode))


@pytest.mark.parametrize("mode", list(SHARING))
def test_run_bag_from_a_shared_state(run, tbatches, mode):
    check_run_bag(run, tbatches, SHARING[mode], OPTION_TOL.get(mode))


def test_one_sinkhorn_call_per_gn_round(tbatches, monkeypatch):
    """Per-hypothesis GN: map_icp_iters calls per scan, each on all K_HYP
    problems at once, C (K_HYP, N, k_assoc) with its a and b."""
    shapes = []
    real = association.sinkhorn_unbalanced

    def recording(Cm, a, b, *args):
        shapes.append((tuple(Cm.shape), tuple(a.shape), tuple(b.shape)))
        return real(Cm, a, b, *args)

    cfg = PipelineConfig(**SMALL, **SHARING["per_hypothesis"])
    state, _ = runner.run_bag(tbatches[:2], cfg, device="cpu")
    monkeypatch.setattr(association, "sinkhorn_unbalanced", recording)
    tstep.scan_step(state, tbatches[2], cfg)
    N, Ka = cfg.n_surfel, cfg.k_assoc
    assert shapes == [((C.K_HYP, N, Ka), (C.K_HYP, N), (C.K_HYP, Ka))] * cfg.map_icp_iters


def test_hypothesis_sharing_modes_track(tbatches):
    """The JAX package's test of the same name on the port: all three
    sharing levels track the trajectory, the per-hypothesis branch within
    5 cm of the shared GN, and only the shared levels carry the
    hyp_shared_extraction trigger."""
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate

    gt = generate(SyntheticConfig(n_scans=10, n_points=512), device="cpu").gt_poses
    results, bits = {}, {}
    for name, kw in {**SHARING, "shared_gn": dict(map_share_extraction=True, map_gn_shared=True)}.items():
        _, out = runner.run_bag(tbatches, PipelineConfig(**SMALL, **kw), device="cpu")
        poses = out.pose.numpy()
        assert np.all(np.isfinite(poses)), name
        err = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1)
        results[name] = float(np.sqrt((err**2).mean()))
        assert results[name] < 0.5, (name, results[name])
        bits[name] = (out.tape.cert_triggers.numpy() & CT.TRIGGERS["hyp_shared_extraction"]) != 0
    assert abs(results["shared_gn"] - results["per_hypothesis"]) < 0.05, results
    assert bits["shared_gn"].all() and bits["shared_extraction"].all()
    assert not bits["per_hypothesis"].any()


# --- the 'evidence'-mode IMU operators (rtol 1e-10 of each output's largest
# magnitude: same formulas, only reduction orders differ) --------------------


def test_predict_diffusion():
    jb, tb = _beliefs(5)
    Q = np.asarray(jiw.process_noise_to_Q(jiw.datasheet_process_noise()))
    jout, jc = _vm(lambda b: jpred.predict_diffusion(b, Q, 0.1))(jb)
    tout, tc = tpred.predict_diffusion(tb, T(Q), torch.tensor(0.1, dtype=torch.float64))
    for f in tout._fields:
        near_rel(getattr(jout, f), getattr(tout, f))
    near_rel(jc.psd_projection_delta, tc.psd_projection_delta, rtol=1e-6, atol=1e-12)
    near_rel(jc.eig_min, tc.eig_min)


def test_imu_gyro_rotation_evidence():
    rng = np.random.default_rng(6)
    r0, r1, d = (rng.normal(size=(K, 3)) * s for s in (0.3, 0.3, 0.05))
    Sg = np.diag([1e-6, 2e-6, 1.5e-6])
    for dt in (0.095, 0.0):
        jL, jh, jr, jc = _vm(lambda a, b, c: jimu.imu_gyro_rotation_evidence(a, b, c, Sg, dt))(r0, r1, d)
        tL, th, tr, tc = timu.imu_gyro_rotation_evidence(T(r0), T(r1), T(d), T(Sg),
                                                         torch.tensor(dt, dtype=torch.float64))
        for j, t in ((jL, tL), (jh, th), (jr, tr), (jc.nll_per_ess, tc.nll_per_ess)):
            near_rel(j, t)


def test_imu_preintegration_factor():
    rng = np.random.default_rng(7)
    p0, p1, v0, v1, dv, dp = (rng.normal(size=(K, 3)) * s for s in (1.0, 1.0, 0.5, 0.5, 0.05, 0.02))
    r0, r1 = rng.normal(size=(K, 3)) * 0.3, rng.normal(size=(K, 3)) * 0.3
    A = rng.normal(size=(2, K, 3, 3)) * 0.01
    Spos, Svel = (a @ np.swapaxes(a, -1, -2) for a in A)
    Sa = np.diag([1e-4, 2e-4, 1.5e-4])
    for dt in (0.095, 0.0):
        jf, jc = _vm(lambda a, b, c, d_, e, f_, g, h, sp, sv: jimu.imu_preintegration_factor(
            a, b, c, d_, e, f_, g, h, Sa, dt, sp, sv))(p0, r0, v0, p1, v1, r1, dv, dp, Spos, Svel)
        tf, tc = timu.imu_preintegration_factor(*[T(x) for x in (p0, r0, v0, p1, v1, r1, dv, dp, Sa)],
                                                torch.tensor(dt, dtype=torch.float64), T(Spos), T(Svel))
        for f in tf._fields:
            near_rel(getattr(jf, f), getattr(tf, f))
        near_rel(jc.nll_per_ess, tc.nll_per_ess)
    # without the head marginals (the reference's own form)
    jf, _ = _vm(lambda a, b, c, d_, e, f_, g, h: jimu.imu_preintegration_factor(
        a, b, c, d_, e, f_, g, h, Sa, 0.1))(p0, r0, v0, p1, v1, r1, dv, dp)
    tf, _ = timu.imu_preintegration_factor(*[T(x) for x in (p0, r0, v0, p1, v1, r1, dv, dp, Sa)],
                                           torch.tensor(0.1, dtype=torch.float64))
    near_rel(jf.L, tf.L)
    near_rel(jf.h, tf.h)
