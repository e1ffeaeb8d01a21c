"""Core math of gcslam_torch against the JAX package on the same numpy
inputs, in float64: se3, linalg, certs and the belief. Tolerance: rtol
1e-10 (atol 1e-12 for entries that are zero in exact arithmetic) — both
sides run the same formulas; only the summation order of small matrix
products differs."""

import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.models import belief as jbel
from gcslam_tpu.ops import certs as jcerts, linalg as jlin, se3 as jse3
from gcslam_torch.models import belief as tbel
from gcslam_torch.ops import certs as tcerts, linalg as tlin, se3 as tse3

RTOL, ATOL = 1e-10, 1e-12


def close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               rtol=rtol, atol=atol)


def T(x):
    return torch.as_tensor(np.array(x))


def _rotvecs(rng, n=16):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([[0.0, 1e-9, 1e-4], rng.uniform(0.0, 3.0, n - 5), [np.pi - 1e-3, 3.1]])
    return axes * angles[:, None]


def _poses(rng, n=16):
    return np.concatenate([rng.normal(size=(n, 3)), _rotvecs(rng, n)], axis=1)


@pytest.mark.parametrize("fn", ["so3_exp", "skew"])
def test_so3_maps(fn):
    rv = _rotvecs(np.random.default_rng(1))
    close(getattr(jse3, fn)(jnp.asarray(rv)), getattr(tse3, fn)(T(rv)))


def test_so3_log():
    R = np.asarray(jse3.so3_exp(jnp.asarray(_rotvecs(np.random.default_rng(2)))))
    close(jse3.so3_log(jnp.asarray(R)), tse3.so3_log(T(R)), rtol=1e-10, atol=ATOL)


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log", "se3_inverse"])
def test_se3_unary(fn):
    x = _poses(np.random.default_rng(3))
    close(getattr(jse3, fn)(jnp.asarray(x)), getattr(tse3, fn)(T(x)), rtol=1e-10, atol=ATOL)


@pytest.mark.parametrize("fn", ["se3_compose", "se3_relative"])
def test_se3_binary(fn):
    rng = np.random.default_rng(4)
    a, b = _poses(rng), _poses(rng)
    close(getattr(jse3, fn)(jnp.asarray(a), jnp.asarray(b)), getattr(tse3, fn)(T(a), T(b)),
          rtol=1e-10, atol=ATOL)


def _spd(rng, shape, d, cond=1e3):
    A = rng.normal(size=shape + (d, d))
    return A @ np.swapaxes(A, -1, -2) + np.eye(d) * (d / cond)


@pytest.mark.parametrize("d", [3, 6, 22])
def test_domain_projection_psd(d):
    rng = np.random.default_rng(d)
    M = rng.normal(size=(5, d, d))  # indefinite, unsymmetric
    Mj, cj = jlin.domain_projection_psd(jnp.asarray(M), 1e-6)
    Mt, ct = tlin.domain_projection_psd(T(M), 1e-6)
    close(Mj, Mt, rtol=1e-10, atol=ATOL)
    for f in cj._fields:
        close(getattr(cj, f), getattr(ct, f), rtol=1e-10, atol=ATOL)


@pytest.mark.parametrize("d", [3, 6, 22])
def test_spd_solve_and_inverse(d):
    rng = np.random.default_rng(10 + d)
    L = _spd(rng, (4,), d)
    b = rng.normal(size=(4, d))
    xj, lj = jlin.spd_solve_lifted(jnp.asarray(L), jnp.asarray(b), 1e-9)
    xt, lt = tlin.spd_solve_lifted(T(L), T(b), 1e-9)
    close(xj, xt, rtol=1e-10)
    assert float(lj) == lt
    close(jlin.spd_inverse_lifted(jnp.asarray(L), 1e-9)[0], tlin.spd_inverse_lifted(T(L), 1e-9)[0], rtol=1e-10)


def test_failed_cholesky_gives_nan_not_an_error():
    L = -np.eye(6)[None].repeat(2, 0)
    xj, _ = jlin.spd_solve_lifted(jnp.asarray(L), jnp.ones((2, 6)), 1e-9)
    xt, _ = tlin.spd_solve_lifted(T(L), torch.ones(2, 6, dtype=torch.float64), 1e-9)
    assert np.all(np.isnan(np.asarray(xj))) and torch.isnan(xt).all()


@pytest.mark.parametrize("fn", ["inv3x3", "det3x3"])
def test_adjugate_kernels(fn):
    M = np.random.default_rng(5).normal(size=(32, 3, 3))
    close(getattr(jlin, fn)(jnp.asarray(M)), getattr(tlin, fn)(T(M)))


def test_solve3x3():
    rng = np.random.default_rng(6)
    M, b = _spd(rng, (32,), 3), rng.normal(size=(32, 3))
    close(jlin.solve3x3(jnp.asarray(M), jnp.asarray(b), 1e-9), tlin.solve3x3(T(M), T(b), 1e-9))


def test_eigh_3x3():
    rng = np.random.default_rng(7)
    Q = np.linalg.qr(rng.normal(size=(64, 3, 3)))[0]
    lam = np.sort(rng.uniform(0.1, 10.0, size=(64, 3)), axis=-1)  # well separated
    M = Q @ (lam[..., None] * np.swapaxes(Q, -1, -2))
    lj, vj = jlin.eigh_3x3(jnp.asarray(M))
    lt, vt = tlin.eigh_3x3(T(M))
    close(lj, lt, rtol=1e-12)
    close(vj, vt, rtol=1e-10, atol=ATOL)


def test_rotation_from_scatter():
    S = np.random.default_rng(8).normal(size=(3, 3)) * 10.0  # full rank
    for j, t in zip(jlin.rotation_from_scatter(jnp.asarray(S)), tlin.rotation_from_scatter(T(S))):
        close(j, t, rtol=1e-10, atol=ATOL)


def test_smooth_projections():
    x = np.linspace(-5.0, 5.0, 41)
    close(jlin.softplus_positive(jnp.asarray(x)), tlin.softplus_positive(T(x)))
    lo = np.full_like(x, -1.0)
    close(jlin.smooth_interval_project(jnp.asarray(x), jnp.asarray(lo), 3.0),
          tlin.smooth_interval_project(T(x), T(lo), 3.0))


def _cert_pair(rng):
    kw = dict(exact=False, triggers=jcerts.TRIGGERS["linearization"] | jcerts.TRIGGERS["approx_selection"],
              ess_total=float(rng.uniform(1, 5)), cond=float(rng.uniform(1, 100)),
              nll_per_ess=float(rng.normal()), power_beta=float(rng.uniform()),
              psd_projection_delta=float(rng.uniform()), anchor_drift_rho=float(rng.uniform()))
    return jcerts.make_cert(**kw), tcerts.make_cert(**kw)


def test_certs_aggregate_magnitude_and_triggers():
    rng = np.random.default_rng(9)
    pairs = [_cert_pair(rng) for _ in range(5)]
    pairs.append((jcerts.make_cert(exact=True, triggers=jcerts.TRIGGERS["NonFiniteEvidence"],
                                   trust_alpha=float("nan")),
                  tcerts.make_cert(exact=True, triggers=tcerts.TRIGGERS["NonFiniteEvidence"],
                                   trust_alpha=float("nan"))))
    aj = jcerts.scrub(jcerts.aggregate([p[0] for p in pairs]))
    at = tcerts.scrub(tcerts.aggregate([p[1] for p in pairs]))
    for f in jcerts.Cert._fields:
        if f == "triggers":
            assert int(getattr(aj, f)) == int(getattr(at, f))
        else:
            close(getattr(aj, f), getattr(at, f))
    close(jcerts.total_trigger_magnitude([p[0] for p in pairs[:5]]),
          tcerts.total_trigger_magnitude([p[1] for p in pairs[:5]]))
    assert jcerts.decode_triggers(int(aj.triggers)) == tcerts.decode_triggers(int(at.triggers))
    assert jcerts.TRIGGERS == tcerts.TRIGGERS


def _belief_pair(rng):
    L = _spd(rng, (3,), 22, cond=1e2)
    h = rng.normal(size=(3, 22))
    X = _poses(rng)[5:8] * 0.3
    jb = jbel.Belief(X_anchor=jnp.asarray(X), z_lin=jnp.zeros((3, 22)), L=jnp.asarray(L),
                     h=jnp.asarray(h), stamp=jnp.zeros(3))
    tb = tbel.Belief(X_anchor=T(X), z_lin=torch.zeros(3, 22, dtype=torch.float64), L=T(L), h=T(h),
                     stamp=torch.zeros(3, dtype=torch.float64))
    return jb, tb


def test_belief_moments_and_world_pose():
    jb, tb = _belief_pair(np.random.default_rng(11))
    close(jbel.mean_increment(jb), tbel.mean_increment(tb), rtol=1e-10)
    close(jbel.to_moments(jb)[1], tbel.to_moments(tb)[1], rtol=1e-10)
    close(jbel.world_pose(jb), tbel.world_pose(tb), rtol=1e-10, atol=ATOL)


def test_identity_prior():
    jp, tp = jbel.identity_prior(2.5), tbel.identity_prior(2.5)
    for f in jbel.Belief._fields:
        close(getattr(jp, f), getattr(tp, f), rtol=0, atol=0)
