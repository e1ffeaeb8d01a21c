"""The reference's contract-test families (tests/test_contracts.py) on the
port's real scan_step, beyond the non-finite cases that
tests/test_torch_slice.py covers:

  - no-gates smoothness: an odometry outlier swept over four orders of
    magnitude moves the pose continuously;
  - IW suffstats: the hypothesis-weighted apply commutes under hypothesis
    permutation, and accumulation order does not matter;
  - the trigger registry and the certificate schema under aggregation;
  - triggers imply the Frobenius recompose; the expected-effect channel
    tracks the realized effect;
  - state and tape shapes match the declared budgets, and budget
    mismatches fail fast;
  - a NaN arriving through a certificate (not L/h) is rejected with the
    NonFiniteEvidence bit, and the next clean scan recovers.

Everything runs on the CPU at the SMALL budgets of test_torch_slice.py."""

import numpy as np
import pytest
import torch

from gcslam_torch import constants as C
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner, scan_step as tstep
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import certs as CT, evidence_imu, iw
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_slice import SMALL

F64 = torch.float64


@pytest.fixture(scope="module")
def small_run():
    return generate(SyntheticConfig(n_scans=6, n_points=512), device="cpu")


@pytest.fixture(scope="module")
def replay(small_run):
    return runner.run_bag(small_run.batches, PipelineConfig(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def after_one(small_run):
    cfg = PipelineConfig(**SMALL)
    state, _ = tstep.scan_step(tstep.init_state(cfg, device="cpu"), small_run.batches[0], cfg)
    return state


def test_no_gates_smoothness_under_outlier_sweep(small_run, after_one):
    """Each pose step is bounded by twice the outlier step: no gate turns a
    small input change into a jump."""
    cfg = PipelineConfig(**SMALL)
    mags = np.concatenate([[0.0], np.logspace(-3, 1, 13)])
    poses = []
    for m in mags:
        b = small_run.batches[1]
        b = b._replace(odom_pose=b.odom_pose + torch.tensor([m, 0, 0, 0, 0, 0], dtype=F64))
        _, out = tstep.scan_step(after_one, b, cfg)
        poses.append(out.pose.numpy())
    poses = np.stack(poses)
    assert np.all(np.isfinite(poses))
    deltas = np.linalg.norm(np.diff(poses[:, :3], axis=0), axis=1)
    assert np.all(deltas <= 2.0 * np.diff(mags) + 1e-6), deltas


def test_iw_apply_commutes_under_hypothesis_permutation():
    rng = np.random.default_rng(7)
    K = 4
    dPsi = rng.normal(size=(K, 7, 6, 6))
    dPsi = dPsi + np.swapaxes(dPsi, -1, -2)
    dnu = np.abs(rng.normal(size=(K, 7)))
    w = np.abs(rng.normal(size=K)) + 0.1
    w = w / w.sum()

    def combined(perm):
        wp = w[list(perm)]
        dP = sum(wp[k] * dPsi[perm[k]] for k in range(K))
        dn = sum(wp[k] * dnu[perm[k]] for k in range(K))
        return iw.process_iw_apply(iw.datasheet_process_noise(), torch.as_tensor(dP), torch.as_tensor(dn))

    a, b = combined([0, 1, 2, 3]), combined([3, 1, 0, 2])
    torch.testing.assert_close(a.Psi, b.Psi, rtol=1e-12, atol=0)
    torch.testing.assert_close(a.nu, b.nu, rtol=1e-12, atol=0)


def test_iw_suffstats_addition_order_invariant():
    rng = np.random.default_rng(11)
    terms = [rng.normal(size=(7, 6, 6)) for _ in range(5)]
    terms = [t + np.swapaxes(t, -1, -2) for t in terms]
    s = iw.datasheet_process_noise()
    ones = torch.ones(7, dtype=F64)
    a = iw.process_iw_apply(s, torch.as_tensor(np.sum(terms, axis=0)), ones)
    b = iw.process_iw_apply(s, torch.as_tensor(np.sum(terms[::-1], axis=0)), ones)
    torch.testing.assert_close(a.Psi, b.Psi, rtol=1e-12, atol=0)


def test_trigger_registry_bits_unique_and_decodable():
    bits = list(CT.TRIGGERS.values())
    assert len(set(bits)) == len(bits)
    assert len(CT.TRIGGER_NAMES) <= 63, "int64 bitmask"
    all_mask = 0
    for b in bits:
        all_mask |= b
    assert set(CT.decode_triggers(all_mask)) == set(CT.TRIGGER_NAMES)
    assert CT.decode_triggers(0) == []


def test_make_cert_schema_complete_and_aggregation_preserves_it():
    c1 = CT.make_cert(exact=False, triggers=CT.TRIGGERS["linearization"], ess_total=5.0, cond=10.0)
    c2 = CT.make_cert(exact=True, triggers=CT.TRIGGERS["mass_drop"], cond=100.0)
    agg = CT.aggregate([c1, c2])
    assert set(agg._fields) == set(CT.Cert._fields)
    for f in CT.Cert._fields:
        v = getattr(agg, f)
        assert v.shape == (), f
        assert torch.isfinite(v.to(F64)), f
    assert set(CT.decode_triggers(int(agg.triggers))) == {"linearization", "mass_drop"}
    assert float(agg.exact) == 0.0
    assert float(agg.cond) == 100.0


def test_triggers_imply_frobenius_on_scan(replay):
    tape = replay[1].tape
    assert torch.all((tape.cert_n_triggers == 0) | (tape.cert_frobenius_applied > 0))


def test_expected_effect_predicted_tracks_realized(replay):
    tape = replay[1].tape
    pred, real = tape.ee_pose_shift_pred.numpy(), tape.ee_pose_shift_real.numpy()
    sig = pred > 1e-6
    assert np.any(sig), "run produced no significant pose shifts"
    ratio = real[sig] / pred[sig]
    assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    gp, gr = tape.ee_info_gain_pred.numpy(), tape.ee_info_gain_real.numpy()
    assert np.all(gr <= gp * 1.05 + 1e-6)
    assert np.any(gp > 0)


def test_clean_run_has_no_nonfinite_trigger(replay):
    assert not (replay[1].tape.cert_triggers & CT.TRIGGERS["NonFiniteEvidence"]).any()


def test_state_and_tape_shapes_match_declared_budgets(small_run):
    cfg = PipelineConfig(**SMALL)
    state = tstep.init_state(cfg, device="cpu")
    assert state.beliefs.L.shape == (C.K_HYP, C.D_Z, C.D_Z)
    assert state.beliefs.h.shape == (C.K_HYP, C.D_Z)
    assert state.hyp_weights.shape == (C.K_HYP,)
    assert state.process_iw.Psi.shape == (7, 6, 6)
    assert state.meas_iw.Psi.shape == (3, 3, 3)
    assert state.atlas.Lambdas.shape == (cfg.atlas_max_tiles, cfg.m_tile, 3, 3)
    assert state.atlas.tile_ids.shape == (cfg.atlas_max_tiles,)

    state, out = tstep.scan_step(state, small_run.batches[0], cfg)
    per_insert = {"map_ins_ids": (), "map_ins_tiles": (), "map_ins_mu": (3,), "map_ins_w": ()}
    n_ins = out.tape.map_ins_ids.shape[0]
    assert n_ins > 0 and n_ins % cfg.k_insert_tile == 0, n_ins
    for f in tstep.ScanTape._fields:
        got = tuple(getattr(out.tape, f).shape)
        assert got == ((n_ins,) + per_insert[f] if f in per_insert else ()), (f, got)
    b = small_run.batches[0]
    assert b.points.shape[0] <= C.N_POINTS_CAP
    assert b.imu_stamps.shape == (C.MAX_IMU_PREINT_LEN,)
    assert b.cam_Lambdas.shape == (C.N_FEAT, 3, 3)


def test_batch_budget_mismatch_fails_fast():
    with pytest.raises(ValueError, match="compiled constant"):
        PipelineConfig(k_hyp=C.K_HYP + 1).validate()
    with pytest.raises(ValueError, match="outside declared range"):
        PipelineConfig(forgetting_factor=1.5).validate()


def test_cert_channel_nan_rejected(small_run, after_one, monkeypatch):
    """A NaN in the gravity certificate's ESS (its L/h stay finite): the
    NonFiniteEvidence bit, beta 0, a finite pose and tape; the next clean
    scan fuses evidence again."""
    cfg = PipelineConfig(**SMALL)
    real = evidence_imu.imu_gravity_evidence_time_resolved

    def poisoned(*a, **kw):
        grav, cert = real(*a, **kw)
        return grav, cert._replace(ess_total=torch.full_like(cert.ess_total, float("nan")))

    monkeypatch.setattr(evidence_imu, "imu_gravity_evidence_time_resolved", poisoned)
    state, out = tstep.scan_step(after_one, small_run.batches[1], cfg)
    assert int(out.tape.cert_triggers) & CT.TRIGGERS["NonFiniteEvidence"]
    assert float(out.tape.power_beta) == 0.0
    assert torch.isfinite(out.pose).all()
    for f in tstep.ScanTape._fields:
        assert torch.isfinite(getattr(out.tape, f).to(F64)).all(), f
    monkeypatch.undo()
    _, out2 = tstep.scan_step(state, small_run.batches[2], cfg)
    assert not int(out2.tape.cert_triggers) & CT.TRIGGERS["NonFiniteEvidence"]
    assert float(out2.tape.power_beta) > 0.0 and torch.isfinite(out2.pose).all()
