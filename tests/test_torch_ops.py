"""The port's per-scan operators against the JAX package's, with the K_HYP
hypothesis axis the port writes out as a leading dimension and the JAX
package vmaps: windows, preintegration, IMU prediction, IMU/odometry
evidence, fusion, recompose, IW noise, barycenter, deskew, tiling, kappa.

Tolerance: float64 rtol 1e-10 of each output's largest magnitude (same
formulas; only reduction orders differ), float32 deskew 1e-5 m."""

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.models import belief as jbel
from gcslam_tpu.ops import (deskew as jdsk, evidence_imu as jimu, evidence_odom as jodo, fusion as jfus,
                            hypothesis as jhyp, iw as jiw, kappa as jkap, predict as jpred,
                            preintegration as jpre, recompose as jrec, tiling as jtil, windows as jwin)
from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_torch.models import belief as tbel
from gcslam_torch.ops import (deskew as tdsk, evidence_imu as timu, evidence_odom as todo, fusion as tfus,
                              hypothesis as thyp, iw as tiw, kappa as tkap, predict as tpred,
                              preintegration as tpre, recompose as trec, tiling as ttil, windows as twin)

K = 4
RTOL = 1e-10


def T(x):
    return torch.as_tensor(np.array(x))


def near(ref, got, rtol=RTOL, atol=0.0):
    ref = np.asarray(ref).astype(np.float64)
    got = got.detach().numpy().astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max() + atol


@pytest.fixture(scope="module")
def scan():
    b = jgenerate(JSynth(n_scans=3, n_points=512)).batches[2]
    return jax.tree_util.tree_map(np.asarray, b)


def _beliefs(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, 22, 22))
    L = A @ np.swapaxes(A, -1, -2) + 50.0 * np.eye(22)
    h = rng.normal(size=(K, 22)) * 5.0
    X = np.concatenate([rng.normal(size=(K, 3)), rng.normal(size=(K, 3)) * 0.3], axis=1)
    z = rng.normal(size=(K, 22)) * 0.01
    st = np.full(K, 0.2)
    jb = jbel.Belief(*[jnp.asarray(x) for x in (X, z, L, h, st)])
    return jb, tbel.Belief(*[T(x) for x in (X, z, L, h, st)])


def _vm(fn):
    return jax.vmap(fn)


def test_windows_and_preintegration(scan):
    sig = np.array([0.01, 0.012, 0.02, 0.011])
    jw = _vm(lambda s: jwin.smooth_window_weights(scan.imu_stamps, scan.t_last_scan, scan.t_scan, s))(sig)
    tw = twin.smooth_window_weights(T(scan.imu_stamps), T(scan.t_last_scan), T(scan.t_scan), T(sig))
    near(jw, tw)
    rng = np.random.default_rng(0)
    rv, bg, ba = rng.normal(size=(K, 3)) * 0.2, rng.normal(size=(K, 3)) * 1e-3, rng.normal(size=(K, 3)) * 1e-2
    target = jpre.imu_integration_time(scan.imu_stamps, scan.t_last_scan, scan.t_scan)
    g = jnp.asarray([0.0, 0.0, -9.81])
    jp = _vm(lambda w, r, gb, ab: jpre.preintegrate(scan.imu_stamps, scan.imu_gyro, scan.imu_accel,
                                                     w, r, gb, ab, g, target))(jw, rv, bg, ba)
    tp = tpre.preintegrate(T(scan.imu_stamps), T(scan.imu_gyro), T(scan.imu_accel), tw, T(rv), T(bg), T(ba),
                           T(g), T(target))
    for f in tpre.PreintResult._fields:
        near(getattr(jp, f), getattr(tp, f))
    near(target, tpre.imu_integration_time(T(scan.imu_stamps), T(scan.t_last_scan), T(scan.t_scan)))
    near(jpre.imu_mean_sample_period(scan.imu_stamps), tpre.imu_mean_sample_period(T(scan.imu_stamps)))


def test_cumulative_matmul_is_the_sequential_product():
    rng = np.random.default_rng(1)
    M = np.linalg.qr(rng.normal(size=(37, 3, 3)))[0]
    seq = [M[0]]
    for m in M[1:]:
        seq.append(seq[-1] @ m)
    near(np.stack(seq), tpre.cumulative_matmul(T(M)), rtol=1e-12)


def test_predict_imu(scan):
    jb, tb = _beliefs(2)
    rng = np.random.default_rng(3)
    dpose, dv = rng.normal(size=(K, 6)) * 0.05, rng.normal(size=(K, 3)) * 0.05
    Q = np.asarray(jiw.process_noise_to_Q(jiw.datasheet_process_noise()))
    Sg, Sa = np.eye(3) * 1e-6, np.eye(3) * 1e-4
    args = (0.1, 0.095)
    jout, jc = _vm(lambda b, p, v: jpred.predict_imu(b, Q, args[0], p, v, args[1], Sg, Sa))(jb, dpose, dv)
    tout, tc = tpred.predict_imu(tb, T(Q), torch.tensor(args[0], dtype=torch.float64), T(dpose), T(dv),
                                 torch.tensor(args[1], dtype=torch.float64), T(Sg), T(Sa))
    for f in jbel.Belief._fields:
        near(getattr(jout, f), getattr(tout, f))
    near(jc.psd_projection_delta, tc.psd_projection_delta, rtol=1e-6, atol=1e-12)


def test_imu_gravity_evidence_and_inflation(scan):
    rng = np.random.default_rng(4)
    rv, ba = rng.normal(size=(K, 3)) * 0.1, rng.normal(size=(K, 3)) * 1e-2
    w = rng.uniform(0.2, 1.0, size=(K, scan.imu_stamps.shape[0]))
    g = np.array([0.0, 0.0, -9.81])
    dt = 0.005
    jg, jc = _vm(lambda r, ww, b: jimu.imu_gravity_evidence_time_resolved(
        r, scan.imu_accel, scan.imu_gyro, ww, b, g, dt))(rv, w, ba)
    tg, tc = timu.imu_gravity_evidence_time_resolved(T(rv), T(scan.imu_accel), T(scan.imu_gyro), T(w), T(ba),
                                                     T(g), torch.tensor(dt, dtype=torch.float64))
    for f in timu.GravityEvidence._fields:
        near(getattr(jg, f), getattr(tg, f), rtol=1e-9)
    for f in ("ess_total", "nll_per_ess", "trust_alpha", "directional_score"):
        near(getattr(jc, f), getattr(tc, f), rtol=1e-9)
    js, _ = jimu.imu_dependence_inflation(jg.transport_sigma)
    ts, _ = timu.imu_dependence_inflation(tg.transport_sigma)
    near(js, ts, rtol=1e-9)


def test_odometry_and_planar_factors(scan):
    rng = np.random.default_rng(5)
    pose = np.concatenate([rng.normal(size=(K, 3)), rng.normal(size=(K, 3)) * 0.2], 1)
    pose0 = pose + rng.normal(size=(K, 6)) * 0.02
    vel = rng.normal(size=(K, 3))
    Sp = np.tile(np.eye(3) * 1e-3, (K, 1, 1))
    o = scan
    outs_j = _vm(lambda p, p0, v, S: (
        jodo.odom_quadratic_evidence(p, o.odom_pose, o.odom_cov),
        jodo.odom_velocity_evidence(v, jodo.se3.so3_exp(p[3:6]), o.odom_twist[:3], o.odom_twist_cov[:3, :3]),
        jodo.odom_yawrate_evidence(v[2], o.odom_twist[5], 0.01, 0.1, S[2, 2]),
        jodo.pose_twist_kinematic_consistency(p0, p, o.odom_twist[:3], o.odom_twist[3:6], 0.1,
                                              o.odom_twist_cov[:3, :3], o.odom_twist_cov[3:6, 3:6], S, S),
        jodo.planar_z_prior(p), jodo.velocity_z_prior(v[2]),
    ))(pose, pose0, vel, Sp)
    tp, tp0, tv, tS = T(pose), T(pose0), T(vel), T(Sp)
    f64 = dict(dtype=torch.float64)
    outs_t = (
        todo.odom_quadratic_evidence(tp, T(o.odom_pose), T(o.odom_cov)),
        todo.odom_velocity_evidence(tv, todo.se3.so3_exp(tp[:, 3:6]), T(o.odom_twist[:3]),
                                    T(o.odom_twist_cov[:3, :3])),
        todo.odom_yawrate_evidence(tv[:, 2], T(o.odom_twist[5]), torch.tensor(0.01, **f64),
                                   torch.tensor(0.1, **f64), tS[:, 2, 2]),
        todo.pose_twist_kinematic_consistency(tp0, tp, T(o.odom_twist[:3]), T(o.odom_twist[3:6]),
                                              torch.tensor(0.1, **f64), T(o.odom_twist_cov[:3, :3]),
                                              T(o.odom_twist_cov[3:6, 3:6]), tS, tS),
        todo.planar_z_prior(tp), todo.velocity_z_prior(tv[:, 2]),
    )
    for j, t in zip(outs_j, outs_t):
        jL, jh = (j[0].L, j[0].h) if isinstance(j[0], tuple) else (j[0], j[1])
        tL, th = (t[0].L, t[0].h) if isinstance(t[0], tuple) else (t[0], t[1])
        near(jL, tL)
        near(jh, th)
    jk, tk = outs_j[3][0], outs_t[3][0]
    js, _ = jodo.odom_dependence_inflation(jk.r_trans[0], jk.r_rot[0])
    ts, _ = todo.odom_dependence_inflation(tk.r_trans[0], tk.r_rot[0])
    near(js, ts)


def test_fusion_recompose_and_drift():
    jb, tb = _beliefs(6)
    rng = np.random.default_rng(7)
    A = rng.normal(size=(K, 22, 22))
    Lev = A @ np.swapaxes(A, -1, -2)
    hev = rng.normal(size=(K, 22))
    alpha = np.full(K, 0.9)
    jsent = _vm(jfus.observability_sentinels)(Lev)
    tsent = tfus.observability_sentinels(T(Lev))
    near(jsent.z_to_xy_ratio, tsent.z_to_xy_ratio)
    jbeta, _ = _vm(lambda s, e: jfus.power_tempering_beta(s, e, 2.0))(jsent, np.full(K, 30.0))
    tbeta, _ = tfus.power_tempering_beta(tsent, T(np.full(K, 30.0)), torch.tensor(2.0, dtype=torch.float64))
    near(jbeta, tbeta)
    js = _vm(jfus.excitation_scales)(Lev, jb.L)
    ts = tfus.excitation_scales(T(Lev), tb.L)
    near(js[0], ts[0])
    jLp = _vm(jfus.apply_excitation_prior_scaling)(jb.L, jb.h, js[0], js[1])
    tLp = tfus.apply_excitation_prior_scaling(tb.L, tb.h, ts[0], ts[1])
    near(jLp[0], tLp[0])
    near(jLp[1], tLp[1])
    jf = _vm(jfus.info_fusion_additive)(jb.L, jb.h, Lev, hev, alpha)
    tf = tfus.info_fusion_additive(tb.L, tb.h, T(Lev), T(hev), T(alpha))
    near(jf[0], tf[0])
    near(jf[1], tf[1])
    mag = np.array([0.0, 0.5, 2.0, 7.0])
    jr, _ = _vm(jrec.pose_update_frobenius_recompose)(jb, mag)
    tr, _ = trec.pose_update_frobenius_recompose(tb, T(mag))
    for f in jbel.Belief._fields:
        near(getattr(jr.belief, f), getattr(tr.belief, f))
    jd, _ = _vm(jrec.anchor_drift_update)(jr.belief)
    td, _ = trec.anchor_drift_update(tr.belief)
    for f in jbel.Belief._fields:
        near(getattr(jd.belief, f), getattr(td.belief, f))
    near(jd.rho, td.rho)


def test_iw_noise_and_barycenter(scan):
    jp, tp = jiw.datasheet_process_noise(), tiw.datasheet_process_noise()
    near(jiw.process_noise_to_Q(jp), tiw.process_noise_to_Q(tp))
    jb, tb = _beliefs(8)
    jb2, tb2 = _beliefs(9)
    A = np.random.default_rng(10).normal(size=(K, 22, 22))
    Lev = A @ np.swapaxes(A, -1, -2)
    jd = _vm(lambda a, b, c, d, e: jiw.process_iw_suffstats(a, b, c, d, 1e-9, e))(jb.L, jb.h, jb2.L, jb2.h, Lev)
    td = tiw.process_iw_suffstats(tb.L, tb.h, tb2.L, tb2.h, 1e-9, T(Lev))
    near(jd[0], td[0], rtol=1e-9)
    near(jd[1], td[1])
    jnew, _ = jiw.process_iw_apply(jp, jd[0][0], jd[1][0])
    tnew = tiw.process_iw_apply(tp, td[0][0], td[1][0])
    near(jnew.Psi, tnew.Psi, rtol=1e-9)
    near(jnew.nu, tnew.nu)
    jm, tm = jiw.datasheet_measurement_noise(), tiw.datasheet_measurement_noise()
    w = np.random.default_rng(11).uniform(size=scan.imu_gyro.shape[0])
    bias, om = np.array([1e-3, 0.0, -1e-3]), np.array([0.0, 0.0, 0.1])
    jg = jiw.gyro_meas_suffstats(scan.imu_gyro, w, bias, om, 0.005)
    tg = tiw.gyro_meas_suffstats(T(scan.imu_gyro), T(w), T(bias), T(om), torch.tensor(0.005, dtype=torch.float64))
    near(jg[0], tg[0], rtol=1e-9)
    near(jg[1], tg[1])
    jm2, _ = jiw.measurement_iw_apply(jm, jg[0], jg[1])
    tm2 = tiw.measurement_iw_apply(tm, tg[0], tg[1])
    near(jm2.Psi, tm2.Psi, rtol=1e-9)
    for i in range(3):
        near(jiw.measurement_noise_mode(jm2, i), tiw.measurement_noise_mode(tm2, i), rtol=1e-9)
    wts = np.array([0.4, 0.3, 0.2, 0.1])
    jo, _ = jhyp.hypothesis_barycenter(jb, jnp.asarray(wts))
    to, _ = thyp.hypothesis_barycenter(tb, T(wts))
    for f in jbel.Belief._fields:
        near(getattr(jo.belief, f), getattr(to.belief, f))
    near(jo.spread_proxy, to.spread_proxy)


def test_deskew(scan):
    xi = np.array([0.05, 0.002, 0.0, 0.0, 0.0, 0.01])
    jp, jw, _ = jdsk.deskew_constant_twist(scan.points, scan.point_stamps, scan.point_weights,
                                          scan.scan_start_time, scan.scan_end_time, jnp.asarray(xi), 1.0)
    tp, tw, _ = tdsk.deskew_constant_twist(T(scan.points), T(scan.point_stamps), T(scan.point_weights),
                                          T(scan.scan_start_time), T(scan.scan_end_time), T(xi),
                                          torch.tensor(1.0, dtype=torch.float64))
    near(jp, tp, rtol=0, atol=1e-5)  # float32 trig of the per-point twist
    near(jw, tw, rtol=1e-6)


def test_tiling_and_kappa():
    rng = np.random.default_rng(12)
    xyz = rng.uniform(-50, 50, size=(256, 3))
    assert np.array_equal(np.asarray(jtil.tile_ids_from_xyz(jnp.asarray(xyz), 2.0)),
                          ttil.tile_ids_from_xyz(T(xyz), 2.0).numpy())
    for c in xyz[:5]:
        assert np.array_equal(np.asarray(jtil.stencil_tile_ids(jnp.asarray(c), 1, 0, 2.0)),
                              ttil.stencil_tile_ids(T(c), 1, 0, 2.0).numpy())
    R = np.linspace(-0.1, 1.1, 97)
    jk, jd = jkap.kappa_from_resultant(jnp.asarray(R))
    tk, td = tkap.kappa_from_resultant(T(R))
    near(jk, tk)
    near(jd, td)
