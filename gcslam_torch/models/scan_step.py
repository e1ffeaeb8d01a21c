"""The scan step — the per-scan pipeline as one function on tensors
(counterpart of the JAX package's models/scan_step.py).

    scan_step(state, batch, config) -> (state', StepOutput)

The K_HYP hypotheses run as a leading batch dimension of every belief
tensor (the JAX package vmaps them). The map branch has three sharing
levels (config.map_share_extraction / map_gn_shared):
  - shared GN (the default): one surfel extraction and one Gauss-Newton
    chain per scan from hypothesis 0's predicted pose, before the
    hypotheses run; every hypothesis receives its alignment factor;
  - shared extraction: the hypothesis-0 extraction, then one GN chain per
    hypothesis from its own z_lin;
  - per hypothesis (the reference's semantics): each hypothesis deskews
    with its own twist, extracts its own surfels and runs its own GN chain.
The per-hypothesis GN chains run together: every round is one batched
association and one Sinkhorn launch for all K_HYP problems. The step is
branch-free: Python `if` only on the static config, and no value is read
back to the host.

Per-scan order: soft IMU windows -> two-window preintegration -> IMU
prediction -> IMU/odom evidence -> z_lin -> map evidence -> tempering ->
excitation scaling -> fusion alpha -> additive fusion -> Frobenius
recompose -> IW suffstats -> anchor drift; then barycenter, IW apply and
the map update from hypothesis 0.

On a device mesh (parallel/mesh.py) scan_step takes `shard`, a
ShardContext (ops/collectives.py). On a "hyp" axis the state holds this rank's block of the
hypotheses (beliefs, hyp_weights): hypothesis 0's belief is gathered
before the map branch reads it, _hypothesis_step runs on the local block,
its outputs are gathered over "hyp", and the weight update, barycenter, IW
averaging, map update and tape run on the whole set, replicated on every
hyp rank, whose new beliefs and weights are then cut back to the block. On
a "map" axis the atlas functions read and write a tile-sharded atlas
(models/atlas.py). With shard=None nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gcslam_torch import constants as C
from gcslam_torch.models import atlas as atlas_mod
from gcslam_torch.models.belief import Belief, identity_prior, mean_increment, to_moments, world_pose
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import ScanBatch
from gcslam_torch.ops import certs as CT
from gcslam_torch.ops import collectives, evidence_imu, evidence_odom, fusion, iw, linalg, recompose, se3, tiling
from gcslam_torch.ops.deskew import deskew_constant_twist, deskew_points, deskew_weights
from gcslam_torch.ops.hypothesis import hypothesis_barycenter
from gcslam_torch.ops.predict import predict_diffusion, predict_imu
from gcslam_torch.ops.preintegration import imu_integration_time, imu_mean_sample_period, preintegrate
from gcslam_torch.ops.se3 import mv
from gcslam_torch.ops.windows import smooth_window_weights
from gcslam_torch.utils.device import resolve_device
from gcslam_torch.utils.dtypes import BELIEF_DTYPE
from gcslam_torch.utils.tree import tree_leaves, tree_rebuild


class StepState(NamedTuple):
    beliefs: Belief  # leading (K_HYP,) dim
    hyp_weights: torch.Tensor  # (K_HYP,)
    process_iw: iw.ProcessNoiseIW
    meas_iw: iw.MeasurementNoiseIW
    atlas: object  # AtlasState | None
    scan_count: torch.Tensor  # () int32


class ScanTape(NamedTuple):
    """Per-scan diagnostics (same fields as the JAX package's ScanTape)."""

    timestamp: torch.Tensor
    dt_sec: torch.Tensor
    fusion_alpha: torch.Tensor
    power_beta: torch.Tensor
    cond_pose6: torch.Tensor
    eigmin_pose6: torch.Tensor
    total_trigger_magnitude: torch.Tensor
    cert_exact: torch.Tensor
    cert_frobenius_applied: torch.Tensor
    cert_n_triggers: torch.Tensor
    cert_triggers: torch.Tensor  # int64 bitmask
    support_ess_total: torch.Tensor
    support_frac: torch.Tensor
    mismatch_nll_per_ess: torch.Tensor
    mismatch_directional_score: torch.Tensor
    excitation_dt_effect: torch.Tensor
    excitation_extrinsic_effect: torch.Tensor
    influence_psd_projection_delta: torch.Tensor
    influence_anchor_drift_rho: torch.Tensor
    influence_dt_scale: torch.Tensor
    influence_extrinsic_scale: torch.Tensor
    overconfidence_dt_asymmetry: torch.Tensor
    overconfidence_z_to_xy_ratio: torch.Tensor
    overconfidence_ess_to_excitation: torch.Tensor
    hyp_spread: torch.Tensor
    ee_pose_shift_pred: torch.Tensor
    ee_pose_shift_real: torch.Tensor
    ee_info_gain_pred: torch.Tensor
    ee_info_gain_real: torch.Tensor
    map_fused_mass: torch.Tensor
    map_insert_mass: torch.Tensor
    map_evicted_mass: torch.Tensor
    map_n_culled: torch.Tensor
    map_n_merged: torch.Tensor
    map_valid_total: torch.Tensor
    ot_transport_mass: torch.Tensor
    ot_marginal_defect_a: torch.Tensor
    map_ins_ids: torch.Tensor
    map_ins_tiles: torch.Tensor
    map_ins_mu: torch.Tensor
    map_ins_w: torch.Tensor
    io_n_points_valid: torch.Tensor
    io_n_imu_valid: torch.Tensor
    io_imu_coverage: torch.Tensor
    io_n_cam_valid: torch.Tensor
    io_loop_weight: torch.Tensor
    io_point_weight_sum: torch.Tensor


class StepOutput(NamedTuple):
    pose: torch.Tensor  # (6,) combined world pose [trans, rotvec]
    stamp: torch.Tensor  # ()
    tape: ScanTape


class HypOutputs(NamedTuple):
    """Per-hypothesis results; every field has a leading (K,) dim."""

    belief: Belief
    dPsi_proc: torch.Tensor
    dnu_proc: torch.Tensor
    dPsi_meas: torch.Tensor
    dnu_meas: torch.Tensor
    cert_agg: CT.Cert
    total_trigger_mag: torch.Tensor
    cond_pose6: torch.Tensor
    eigmin_pose6: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    sent_dt_asym: torch.Tensor
    sent_z_ratio: torch.Tensor
    ess_to_exc: torch.Tensor
    s_dt: torch.Tensor
    s_ex: torch.Tensor
    ee_pose_shift_pred: torch.Tensor
    ee_pose_shift_real: torch.Tensor
    ee_info_gain_pred: torch.Tensor
    ee_info_gain_real: torch.Tensor
    z_t_pose: torch.Tensor  # (K, 6) post-recompose world pose
    map_extras: object  # atlas.MapExtras (leading K dim when per hypothesis) | None


def _nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _warp_sigma(Sigma: torch.Tensor, dt_sec: torch.Tensor) -> torch.Tensor:
    """Soft IMU window width from the dt marginal, capped at a quarter scan."""
    dt_std = torch.sqrt(Sigma[..., C.IDX_DT, C.IDX_DT].abs())
    warp_cap = torch.clamp(0.25 * dt_sec, min=0.01)
    return torch.minimum(torch.clamp(dt_std, min=0.01), warp_cap)


def _gravity(cfg, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(C.GRAVITY_W, dtype=BELIEF_DTYPE, device=like.device) * cfg.imu_gravity_scale


def _hypothesis_step(
    belief_prev: Belief,  # (K,) beliefs
    batch: ScanBatch,
    Q: torch.Tensor,
    Sigma_g: torch.Tensor,
    Sigma_a: torch.Tensor,
    map_branch,
    config: PipelineConfig,
    inputs_finite: torch.Tensor,
    beta_scale: torch.Tensor,  # (K,)
    map_scale: torch.Tensor,  # (K,)
) -> HypOutputs:
    """Steps 2-14 + 16 for all hypotheses at once (leading K dim).

    `map_branch` is None (no map), the (L_lidar, h_lidar, certs, MapExtras)
    of the shared GN chain, or the per-hypothesis map branch
    `fn(points_k, deskewed_weights, batch, z_lin_world (K, 6))`
    (atlas.make_map_evidence_fn), called after every hypothesis has its
    z_lin; points_k holds each hypothesis' deskewed points when it extracts
    its own surfels (map_share_extraction=False), else None."""
    cfg = config
    dev = Q.device
    all_certs = []
    imu_predict = cfg.imu_mode == "predict"

    def s2(x):
        return x[..., None, None]

    # --- Step 3: soft IMU membership windows
    _, Sigma_prev_full, _ = to_moments(belief_prev, cfg.eps_lift)
    sigma_warp = _warp_sigma(Sigma_prev_full, batch.dt_sec)
    w_imu_scan = smooth_window_weights(batch.imu_stamps, batch.scan_start_time, batch.scan_end_time, sigma_warp)
    w_imu_int = smooth_window_weights(batch.imu_stamps, batch.t_last_scan, batch.t_scan, sigma_warp)

    mu_prev = mean_increment(belief_prev, cfg.eps_lift)
    gyro_bias = mu_prev[..., C.IDX_BG]
    accel_bias = mu_prev[..., C.IDX_BA]
    pose0 = world_pose(belief_prev, cfg.eps_lift)
    rotvec0 = pose0[..., 3:6]
    gravity_W = _gravity(cfg, Q)

    # --- Step 4: preintegration of both windows in one batched scan
    dt_int = imu_integration_time(batch.imu_stamps, batch.t_last_scan, batch.t_scan)
    dt_imu = imu_mean_sample_period(batch.imu_stamps)
    dt_cov_scan = imu_integration_time(batch.imu_stamps, batch.scan_start_time, batch.scan_end_time)
    target_scan = torch.minimum(
        torch.clamp(batch.scan_end_time - batch.scan_start_time, min=0.0), dt_cov_scan + dt_imu)
    target_int = torch.minimum(torch.clamp(batch.t_scan - batch.t_last_scan, min=0.0), dt_int + dt_imu)
    pre2 = preintegrate(
        batch.imu_stamps, batch.imu_gyro, batch.imu_accel,
        torch.stack([w_imu_scan, w_imu_int]), rotvec0, gyro_bias, accel_bias, gravity_W,
        torch.stack([target_scan, target_int])[:, None],
    )
    pre_scan = type(pre2)(*[x[0] for x in pre2])
    pre_int = type(pre2)(*[x[1] for x in pre2])

    # --- Step 2: prediction. 'predict': IMU prediction with the wheel
    # yaw-rate fused into the increment; 'evidence': OU diffusion (the
    # preintegration enters as factors below)
    if imu_predict:
        delta_pose_f = pre_int.delta_pose
        if cfg.enable_odom_twist:
            var_g = Sigma_g[2, 2] * torch.clamp(dt_int, min=1e-6)
            sigma_wz_sq = torch.clamp(batch.odom_twist_cov[5, 5], min=1e-12)
            var_o = sigma_wz_sq * torch.clamp(dt_int, min=1e-6) ** 2 + C.EPS_MASS * 1e-3
            w_g = var_o / (var_g + var_o)
            dz_f = w_g * pre_int.delta_pose[..., 5] + (1.0 - w_g) * (batch.odom_twist[5] * dt_int)
            delta_pose_f = torch.cat([pre_int.delta_pose[..., :5], dz_f[..., None]], dim=-1)
        belief_pred, pred_cert = predict_imu(
            belief_prev, Q, batch.dt_sec, delta_pose_f, pre_int.delta_v,
            dt_int, Sigma_g, Sigma_a, cfg.eps_psd, cfg.eps_lift,
        )
    else:
        belief_pred, pred_cert = predict_diffusion(belief_prev, Q, batch.dt_sec, cfg.eps_psd, cfg.eps_lift)
    all_certs.append(pred_cert)
    _, Sigma_pred, _ = to_moments(belief_pred, cfg.eps_lift)
    mu_inc = mean_increment(belief_pred, cfg.eps_lift)

    # IMU measurement-noise suffstats
    imu_valid = (batch.imu_stamps > 0.0).to(BELIEF_DTYPE)
    w_int_valid = w_imu_int * imu_valid
    w_norm = w_int_valid / (w_int_valid.sum(-1, keepdim=True) + cfg.eps_mass)
    omega_avg = torch.sum(w_norm[..., None] * (batch.imu_gyro - gyro_bias[..., None, :]), dim=-2)
    dPsi_g, dnu_g = iw.gyro_meas_suffstats(batch.imu_gyro, w_int_valid, gyro_bias, omega_avg, dt_imu,
                                           cfg.eps_mass)
    dPsi_a, dnu_a = iw.accel_meas_suffstats(rotvec0, batch.imu_accel, w_int_valid, accel_bias,
                                            gravity_W, dt_imu, cfg.eps_mass)
    dPsi_meas = dPsi_g + dPsi_a
    dnu_meas = dnu_g + dnu_a

    # --- Step 5: deskew. The window reweighting is the same for every
    # hypothesis; the points are warped per hypothesis only where each
    # extracts its own surfels (the shared branches deskew hypothesis 0
    # in their pre-pass).
    deskewed_weights, deskew_cert = deskew_weights(batch.point_stamps, batch.point_weights,
                                                   batch.scan_start_time, batch.scan_end_time, pre_scan.ess)
    all_certs.append(deskew_cert)
    points_k = None
    if callable(map_branch) and not cfg.map_share_extraction:
        xi_body = se3.se3_log(pre_scan.delta_pose)
        if cfg.deskew_rotation_only:
            xi_body = torch.cat([xi_body[..., :3] * 0.0, xi_body[..., 3:]], dim=-1)
        points_k = [deskew_points(batch.points, batch.point_stamps, batch.scan_start_time, batch.scan_end_time, xi)
                    for xi in xi_body]

    # --- Step 6: IMU + odom evidence -> z_lin
    pose_pred = world_pose(belief_pred, cfg.eps_lift)
    if cfg.odom_pose_mode == "relative":
        # target pose0 o odom_rel; the covariance adds the head's predicted
        # translation and rotation marginals to the odometry delta's
        head = torch.zeros_like(Sigma_pred[..., C.IDX_POSE, C.IDX_POSE])
        head[..., 0:3, 0:3] = Sigma_pred[..., C.IDX_TRANS, C.IDX_TRANS]
        head[..., 3:6, 3:6] = Sigma_pred[..., C.IDX_ROT, C.IDX_ROT]
        L_odom, h_odom, odom_cert = evidence_odom.odom_quadratic_evidence(
            pose_pred, se3.se3_compose(pose0, batch.odom_rel_pose), batch.odom_rel_cov + head,
            cfg.eps_psd, cfg.eps_lift)
    else:
        L_odom, h_odom, odom_cert = evidence_odom.odom_quadratic_evidence(
            pose_pred, batch.odom_pose, batch.odom_cov, cfg.eps_psd, cfg.eps_lift)
    all_certs.append(odom_cert)
    L_loop, h_loop, _ = evidence_odom.odom_quadratic_evidence(
        pose_pred, batch.loop_pose, batch.loop_cov, cfg.eps_psd, cfg.eps_lift)
    L_loop = batch.loop_weight * L_loop
    h_loop = batch.loop_weight * h_loop

    grav, grav_cert = evidence_imu.imu_gravity_evidence_time_resolved(
        pose_pred[..., 3:6], batch.imu_accel, batch.imu_gyro, w_imu_int,
        accel_bias, gravity_W, dt_imu, cfg.eps_psd, cfg.eps_mass)
    all_certs.append(grav_cert)
    imu_dep_scale, dep_cert = evidence_imu.imu_dependence_inflation(grav.transport_sigma, cfg.eps_mass)
    all_certs.append(dep_cert)

    Sigma_prev_pos = Sigma_pred[..., C.IDX_TRANS, C.IDX_TRANS]
    Sigma_prev_rot = Sigma_pred[..., C.IDX_ROT, C.IDX_ROT]
    zero_fac = evidence_imu.zero_preint_factor(Q)
    if imu_predict:
        # the preintegration was consumed by the prediction, so the gyro and
        # preintegration factors are zero (the cert schema stays)
        preint_fac = zero_fac
        L_gyro, h_gyro = zero_fac.L, zero_fac.h
        gyro_cert = CT.make_cert(exact=True, device=dev)
    else:
        L_gyro, h_gyro, _, gyro_cert = evidence_imu.imu_gyro_rotation_evidence(
            rotvec0, pose_pred[..., 3:6], pre_int.delta_pose[..., 3:6], Sigma_g, dt_int,
            cfg.eps_psd, cfg.eps_lift)
        all_certs.append(gyro_cert)
        preint_fac, preint_cert = evidence_imu.imu_preintegration_factor(
            pose0[..., 0:3], rotvec0, mu_prev[..., C.IDX_VEL], pose_pred[..., 0:3], mu_inc[..., C.IDX_VEL],
            pose_pred[..., 3:6], pre_int.delta_v, pre_int.delta_p, Sigma_a, dt_int,
            Sigma_prev_pos, Sigma_pred[..., C.IDX_VEL, C.IDX_VEL], cfg.eps_psd, cfg.eps_lift)
        all_certs.append(preint_cert)

    if cfg.enable_planar_prior:
        L_planar, h_planar, planar_cert = evidence_odom.planar_z_prior(
            pose_pred, cfg.planar_z_ref, cfg.planar_z_sigma)
        all_certs.append(planar_cert)
        L_vz, h_vz, vz_cert = evidence_odom.velocity_z_prior(mu_inc[..., C.IDX_VEL][..., 2],
                                                             cfg.planar_vz_sigma)
        all_certs.append(vz_cert)
    else:
        L_planar, h_planar = zero_fac.L, zero_fac.h
        L_vz, h_vz = zero_fac.L, zero_fac.h

    R_world_body = se3.so3_exp(pose_pred[..., 3:6])
    L_vel, h_vel, vel_cert, _ = evidence_odom.odom_velocity_evidence(
        mu_inc[..., C.IDX_VEL], R_world_body, batch.odom_twist[0:3],
        batch.odom_twist_cov[0:3, 0:3], cfg.eps_psd, cfg.eps_lift)
    all_certs.append(vel_cert)
    sigma_wz = torch.sqrt(torch.clamp(batch.odom_twist_cov[5, 5], min=1e-12))
    L_wz, h_wz, wz_cert = evidence_odom.odom_yawrate_evidence(
        omega_avg[..., 2], batch.odom_twist[5], sigma_wz, batch.dt_sec, Sigma_prev_rot[..., 2, 2])
    all_certs.append(wz_cert)
    kin, kin_cert = evidence_odom.pose_twist_kinematic_consistency(
        pose0, pose_pred, batch.odom_twist[0:3], batch.odom_twist[3:6], batch.dt_sec,
        batch.odom_twist_cov[0:3, 0:3], batch.odom_twist_cov[3:6, 3:6],
        Sigma_prev_pos, Sigma_prev_rot, cfg.eps_psd, cfg.eps_lift)
    all_certs.append(kin_cert)
    odom_dep_scale, odom_dep_cert = evidence_odom.odom_dependence_inflation(
        kin.r_trans, kin.r_rot, cfg.eps_mass)
    all_certs.append(odom_dep_cert)

    twist_on = 1.0 if cfg.enable_odom_twist else 0.0
    # 'predict' mode: the yaw-rate and kinematic factors live in the prediction
    rel_on = 0.0 if imu_predict else twist_on
    od, imd = s2(odom_dep_scale), s2(imu_dep_scale)
    L_imu_odom = (
        od * L_odom + L_loop + imd * (grav.L + L_gyro) + preint_fac.L + L_planar + L_vz
        + twist_on * od * L_vel + rel_on * od * L_wz + rel_on * kin.L
    )
    od1, imd1 = odom_dep_scale[..., None], imu_dep_scale[..., None]
    h_imu_odom = (
        od1 * h_odom + h_loop + imd1 * (grav.h + h_gyro) + preint_fac.h + h_planar + h_vz
        + twist_on * od1 * h_vel + rel_on * od1 * h_wz + rel_on * kin.h
    )
    h_imu_odom = h_imu_odom + mv(L_imu_odom, mu_inc)

    L_fused_psd, _ = linalg.domain_projection_psd(belief_pred.L + L_imu_odom, cfg.eps_psd)
    z_lin_22d, _ = linalg.spd_solve_lifted(L_fused_psd, belief_pred.h + h_imu_odom, cfg.eps_lift)

    # --- Steps 7-8: map evidence, shifted to chart coords at the pose the
    # map factor is linearized at
    if map_branch is not None:
        if callable(map_branch):
            z_lin_world = se3.se3_compose(belief_pred.X_anchor, se3.se3_exp(z_lin_22d[..., C.IDX_POSE]))
            L_lidar, h_lidar, map_certs, extras = map_branch(points_k, deskewed_weights, batch, z_lin_world)
        else:
            L_lidar, h_lidar, map_certs, extras = map_branch
        z_map_chart = se3.se3_log(se3.se3_relative(extras.z_map_pose, belief_pred.X_anchor))
        z_map_22d = torch.cat([z_map_chart, z_lin_22d[..., 6:]], dim=-1)
    else:
        L_lidar = C.EPS_LIFT * linalg.eye(C.D_Z, Q)
        h_lidar = Q.new_zeros(C.D_Z)
        map_certs, extras = [], None
        z_map_22d = z_lin_22d
    h_lidar = h_lidar + mv(L_lidar, z_map_22d)
    ms = cfg.map_evidence_scale * map_scale
    L_lidar = s2(ms) * L_lidar
    h_lidar = ms[..., None] * h_lidar
    all_certs.extend(map_certs)

    if extras is not None:
        lead = extras.z_map_pose.shape[:-1]
        dPsi_l, dnu_l = iw.lidar_meas_suffstats(
            extras.lidar_residuals.reshape(lead + (-1, 3)), extras.lidar_resid_w.reshape(lead + (-1,)),
            cfg.eps_mass)
        dPsi_meas = dPsi_meas + dPsi_l
        dnu_meas = dnu_meas + dnu_l

    # --- Step 9: power tempering, with certified non-finite rejection
    L_ev_raw = L_imu_odom + L_lidar
    h_ev_raw = h_imu_odom + h_lidar
    batch_shape = beta_scale.shape
    certs_finite = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    for c in all_certs:
        for name in CT.FLOAT_FIELDS:
            certs_finite = certs_finite & ~torch.isnan(getattr(c, name))
    ev_finite = (
        torch.isfinite(L_ev_raw).all(-1).all(-1) & torch.isfinite(h_ev_raw).all(-1) & certs_finite
    ).to(L_ev_raw.dtype)
    ev_finite = ev_finite * inputs_finite.to(L_ev_raw.dtype)
    nonfinite = 1.0 - ev_finite
    L_ev_raw = _nan0(L_ev_raw)
    h_ev_raw = _nan0(h_ev_raw)
    nan_cert = CT.make_cert(exact=True, device=dev)._replace(
        exact=ev_finite,
        triggers=(nonfinite > 0).to(CT.TRIGGER_DTYPE) * CT.TRIGGERS["NonFiniteEvidence"],
        n_triggers=nonfinite,
        mass_epsilon_ratio=nonfinite,
    )
    all_certs.append(nan_cert)
    sentinels = fusion.observability_sentinels(L_ev_raw, cfg.eps_mass)
    evidence_cert = CT.scrub(CT.aggregate([deskew_cert, odom_cert, grav_cert, gyro_cert] + map_certs))
    exc_total = evidence_cert.exc_dt_effect + evidence_cert.exc_ex_effect
    beta, temper_cert = fusion.power_tempering_beta(
        sentinels, evidence_cert.ess_total, exc_total,
        cfg.power_beta_min, cfg.power_beta_exc_c, cfg.power_beta_z_c, cfg.eps_mass)
    all_certs.append(temper_cert)
    beta = beta * beta_scale
    beta = torch.where(ev_finite > 0, beta, 0.0)
    L_evidence = s2(beta) * L_ev_raw
    h_evidence = beta[..., None] * h_ev_raw

    # --- Step 10: excitation prior scaling
    s_dt, s_ex = fusion.excitation_scales(L_evidence, belief_pred.L)
    L_prior_scaled, h_prior_scaled, exc_cert = fusion.apply_excitation_prior_scaling(
        belief_pred.L, belief_pred.h, s_dt, s_ex)
    all_certs.append(exc_cert)
    belief_pred = belief_pred._replace(L=L_prior_scaled, h=h_prior_scaled)

    # --- Step 11: fusion alpha (pose-block conditioning)
    L_pose6 = _nan0(linalg.sym(L_evidence[..., C.IDX_POSE, C.IDX_POSE]))
    eig_pose = torch.linalg.eigvalsh(L_pose6)
    eig_pose = torch.clamp(torch.nan_to_num(eig_pose, nan=cfg.eps_psd), min=cfg.eps_psd)
    eigmin_pose6 = eig_pose[..., 0]
    cond_pose6 = eig_pose[..., -1] / eig_pose[..., 0]
    ess_to_exc = evidence_cert.ess_total / (exc_total + cfg.eps_mass)
    alpha, alpha_cert = fusion.fusion_alpha(
        cond_pose6, evidence_cert.ess_total, evidence_cert.support_frac, exc_total,
        sentinels.dt_asymmetry, sentinels.z_to_xy_ratio, beta, evidence_cert.nll_per_ess,
        cfg.alpha_min, cfg.alpha_max, cfg.c0_cond, cfg.eps_mass)
    alpha = torch.where(ev_finite > 0, alpha, cfg.alpha_min)
    all_certs.append(alpha_cert)

    # --- Step 12: additive info fusion
    L_post, h_post, fusion_cert = fusion.info_fusion_additive(
        belief_pred.L, belief_pred.h, L_evidence, h_evidence, alpha, cfg.eps_psd)
    all_certs.append(fusion_cert)
    belief_post = belief_pred._replace(L=L_post, h=h_post)
    ee_pose_pred = torch.linalg.vector_norm(mean_increment(belief_post, cfg.eps_lift)[..., C.IDX_POSE], dim=-1)
    ee_gain_pred = alpha * linalg.trace(L_evidence)
    ee_gain_real = linalg.trace(L_post) - linalg.trace(L_prior_scaled)

    # --- Step 13: Frobenius recompose
    total_mag = _nan0(CT.total_trigger_magnitude(all_certs))
    rec, rec_cert = recompose.pose_update_frobenius_recompose(belief_post, total_mag, cfg.c_frob,
                                                              cfg.eps_lift)
    all_certs.append(rec_cert)
    belief_rec = rec.belief

    # --- Step 14: process IW suffstats
    dPsi_proc, dnu_proc = iw.process_iw_suffstats(
        belief_pred.L, belief_pred.h, belief_rec.L, belief_rec.h, cfg.eps_lift, L_evidence)

    # --- Step 16: anchor drift
    drift, drift_cert = recompose.anchor_drift_update(belief_rec, C.ANCHOR_DRIFT_M0,
                                                      C.ANCHOR_DRIFT_R0, cfg.eps_lift)
    all_certs.append(drift_cert)

    return HypOutputs(
        belief=drift.belief,
        dPsi_proc=dPsi_proc,
        dnu_proc=dnu_proc,
        dPsi_meas=dPsi_meas,
        dnu_meas=dnu_meas,
        cert_agg=CT.Cert(*[x.expand(batch_shape) for x in CT.scrub(CT.aggregate(all_certs))]),
        total_trigger_mag=_nan0(CT.total_trigger_magnitude(all_certs)),
        cond_pose6=cond_pose6,
        eigmin_pose6=eigmin_pose6,
        alpha=alpha,
        beta=beta,
        sent_dt_asym=sentinels.dt_asymmetry,
        sent_z_ratio=sentinels.z_to_xy_ratio,
        ess_to_exc=ess_to_exc,
        s_dt=s_dt,
        s_ex=s_ex,
        ee_pose_shift_pred=ee_pose_pred,
        ee_pose_shift_real=torch.linalg.vector_norm(rec.delta_pose, dim=-1),
        ee_info_gain_pred=ee_gain_pred,
        ee_info_gain_real=ee_gain_real,
        z_t_pose=world_pose(drift.belief, cfg.eps_lift),
        map_extras=extras,
    )


def _shared_extraction_inputs(b0: Belief, batch: ScanBatch, view, cfg, sensor_var):
    """Hypothesis-0 deskew pre-pass feeding the shared surfel extraction and
    shortlist, taken at hypothesis 0's predicted pose (IMU-propagated in
    'predict' mode; the previous pose under the mean-preserving diffusion of
    'evidence' mode)."""
    _, Sigma0, _ = to_moments(b0, cfg.eps_lift)
    sigma_warp = _warp_sigma(Sigma0, batch.dt_sec)
    w_scan = smooth_window_weights(batch.imu_stamps, batch.scan_start_time, batch.scan_end_time, sigma_warp)
    mu0 = mean_increment(b0, cfg.eps_lift)
    pose0 = world_pose(b0, cfg.eps_lift)
    gravity_W = _gravity(cfg, mu0)
    dt_imu = imu_mean_sample_period(batch.imu_stamps)
    dt_cov = imu_integration_time(batch.imu_stamps, batch.scan_start_time, batch.scan_end_time)
    target_scan = torch.minimum(
        torch.clamp(batch.scan_end_time - batch.scan_start_time, min=0.0), dt_cov + dt_imu)
    pre_scan = preintegrate(
        batch.imu_stamps, batch.imu_gyro, batch.imu_accel, w_scan,
        pose0[3:6], mu0[C.IDX_BG], mu0[C.IDX_BA], gravity_W, target_scan)
    xi_body = se3.se3_log(pre_scan.delta_pose)
    if cfg.deskew_rotation_only:
        xi_body = torch.cat([torch.zeros_like(xi_body[:3]), xi_body[3:]])
    dsk_pts, dsk_w, _ = deskew_constant_twist(
        batch.points, batch.point_stamps, batch.point_weights,
        batch.scan_start_time, batch.scan_end_time, xi_body, pre_scan.ess)
    if cfg.imu_mode == "predict":
        w_int = smooth_window_weights(batch.imu_stamps, batch.t_last_scan, batch.t_scan, sigma_warp)
        dt_int = imu_integration_time(batch.imu_stamps, batch.t_last_scan, batch.t_scan)
        target_int = torch.minimum(torch.clamp(batch.t_scan - batch.t_last_scan, min=0.0), dt_int + dt_imu)
        pre_int = preintegrate(
            batch.imu_stamps, batch.imu_gyro, batch.imu_accel, w_int,
            pose0[3:6], mu0[C.IDX_BG], mu0[C.IDX_BA], gravity_W, target_int)
        z_center = se3.se3_compose(pose0, pre_int.delta_pose)
    else:
        z_center = pose0
    inputs = atlas_mod.build_measurement_inputs(
        dsk_pts, batch.point_stamps, dsk_w, batch, view, z_center, cfg, sensor_var)
    return inputs, z_center


def _gather_hypotheses(hyp_out: HypOutputs, hyp_weights: torch.Tensor, hyp, per_hyp_extras: bool):
    """Every hyp rank's HypOutputs and weights, whole, in one collective.
    Per-hypothesis MapExtras shrink to hypothesis 0's (a leading dim of 1),
    the only one the map update reads; shared extras pass through."""
    head = [hyp_out._replace(map_extras=None), hyp_weights]
    n_head = len(tree_leaves(head))
    # each rank sends its first hypothesis's extras: hyp rank 0's is hypothesis 0
    tail = [x[0:1] for x in tree_leaves(hyp_out.map_extras)] if per_hyp_extras else []
    whole = collectives.gather_blocks(tree_leaves(head) + tail, hyp)
    out, weights = tree_rebuild(head, whole[:n_head])
    extras = hyp_out.map_extras
    if per_hyp_extras:
        extras = tree_rebuild(extras, [x[0:1] for x in whole[n_head:]])
    return out._replace(map_extras=extras), weights


def scan_step(state: StepState, batch: ScanBatch, config: PipelineConfig,
              shard=None) -> Tuple[StepState, StepOutput]:
    """One full scan: batched hypotheses -> barycenter -> IW apply -> map update."""
    cfg = config
    dev = state.hyp_weights.device
    hyp = None if shard is None else shard.hyp
    map_shard = None if shard is None else shard.map

    # sensor-boundary non-finite check on the raw batch, then scrub
    batch_finite = torch.ones((), dtype=torch.bool, device=dev)
    for x in batch:
        if x.is_floating_point():
            batch_finite = batch_finite & torch.isfinite(x).all()
    batch = ScanBatch(*[_nan0(x) if x.is_floating_point() else x for x in batch])

    Q = iw.process_noise_to_Q(state.process_iw, cfg.eps_psd)
    Sigma_g = iw.measurement_noise_mode(state.meas_iw, 0, cfg.eps_psd)
    Sigma_a = iw.measurement_noise_mode(state.meas_iw, 1, cfg.eps_psd)
    Sigma_l = iw.measurement_noise_mode(state.meas_iw, 2, cfg.eps_psd)

    atlas = state.atlas
    map_branch = None
    if cfg.with_map:
        if hyp is None:
            b0 = Belief(*[x[0] for x in state.beliefs])
        else:  # hypothesis 0 lives on hyp rank 0
            b0 = Belief(*[g[0] for g in collectives.all_gather([x[0] for x in state.beliefs], hyp)])
        center = world_pose(b0, cfg.eps_lift)[:3]
        active_ids = tiling.stencil_tile_ids(center, cfg.r_active_xy, cfg.r_active_z, cfg.h_tile)
        atlas, active_slots = atlas_mod.allocate_tiles(atlas, active_ids, batch.scan_seq, map_shard)
        atlas, _ = atlas_mod.recency_inflate(atlas, active_slots, batch.scan_seq, cfg, map_shard)
        view = atlas_mod.extract_view(atlas, active_slots, torch.ones_like(active_slots, dtype=torch.bool), cfg,
                                      map_shard)
        sensor_var = linalg.trace(Sigma_l) / 3.0
        shared = None
        if cfg.map_share_extraction:
            shared, z_center = _shared_extraction_inputs(b0, batch, view, cfg, sensor_var)
        if cfg.map_gn_shared:
            # one GN chain per scan from hypothesis 0's predicted pose
            mb_s, sl_s, sc_s = shared
            sc_s = CT.with_triggers(sc_s, CT.TRIGGERS["hyp_shared_extraction"])
            map_branch = atlas_mod.map_gn_evidence(mb_s, sl_s, sc_s, view, batch.scan_seq, z_center, cfg)
        else:
            map_branch = atlas_mod.make_map_evidence_fn(view, cfg, batch.scan_seq, sensor_var, shared)

    if cfg.hyp_diversify and cfg.k_hyp == len(C.HYP_BETA_SCALE):
        beta_scales = torch.tensor(C.HYP_BETA_SCALE, dtype=BELIEF_DTYPE, device=dev)
        map_scales = torch.tensor(C.HYP_MAP_EVIDENCE_SCALE, dtype=BELIEF_DTYPE, device=dev)
    else:
        beta_scales = torch.ones(cfg.k_hyp, dtype=BELIEF_DTYPE, device=dev)
        map_scales = torch.ones(cfg.k_hyp, dtype=BELIEF_DTYPE, device=dev)
    prev_weights = state.hyp_weights
    if hyp is not None:  # this rank's block of the hypotheses
        k_lo, k_hi = hyp.block(cfg.k_hyp)
        beta_scales, map_scales = beta_scales[k_lo:k_hi], map_scales[k_lo:k_hi]
    hyp_out = _hypothesis_step(
        state.beliefs, batch, Q, Sigma_g, Sigma_a, map_branch, cfg,
        inputs_finite=batch_finite, beta_scale=beta_scales, map_scale=map_scales)
    if hyp is not None:
        hyp_out, prev_weights = _gather_hypotheses(hyp_out, state.hyp_weights, hyp,
                                                   cfg.with_map and not cfg.map_gn_shared)

    # per-scan hypothesis weight update from the evidence fit
    if cfg.hyp_diversify:
        ll = -C.HYP_WEIGHT_LL_GAIN * hyp_out.cert_agg.nll_per_ess
        w_upd = prev_weights * torch.exp(ll - ll.amax())
        w_upd = torch.clamp(w_upd / w_upd.sum(), min=C.HYP_WEIGHT_FLOOR)
        hyp_weights = w_upd / w_upd.sum()
    else:
        hyp_weights = prev_weights

    bary, _ = hypothesis_barycenter(hyp_out.belief, hyp_weights, C.HYP_WEIGHT_FLOOR, cfg.eps_psd, cfg.eps_lift)
    pose = world_pose(bary.belief, cfg.eps_lift)

    # IW apply once per scan, hypothesis-weight-averaged suffstats
    w = hyp_weights / hyp_weights.sum()
    dPsi_proc = torch.einsum("k,kbij->bij", w, hyp_out.dPsi_proc)
    dnu_proc = torch.einsum("k,kb->b", w, hyp_out.dnu_proc)
    dPsi_meas = torch.einsum("k,kbij->bij", w, hyp_out.dPsi_meas)
    dnu_meas = torch.einsum("k,kb->b", w, hyp_out.dnu_meas)
    w_process = torch.clamp(state.scan_count.to(BELIEF_DTYPE), max=1.0)
    process_iw = iw.process_iw_apply(state.process_iw, w_process * dPsi_proc, w_process * dnu_proc, cfg.eps_psd)
    meas_iw = iw.measurement_iw_apply(state.meas_iw, dPsi_meas, dnu_meas, cfg.eps_psd)

    f = BELIEF_DTYPE
    if cfg.with_map:
        # the map update follows hypothesis 0
        extras0 = hyp_out.map_extras
        if not cfg.map_gn_shared:
            extras0 = atlas_mod.hypothesis_extras(extras0, 0)
        atlas_new, map_tape = atlas_mod.map_update_step(
            atlas, view, extras0, hyp_out.z_t_pose[0], active_slots, active_ids,
            batch.scan_seq, batch.scan_end_time, cfg, map_shard)
    else:
        atlas_new = atlas
        zero = torch.zeros((), dtype=f, device=dev)
        map_tape = dict(
            fused_mass=zero, insert_mass=zero, evicted_mass=zero, n_culled=zero, n_merged=zero,
            valid_total=zero, ot_transport_mass=zero, ot_marginal_defect_a=zero,
            ins_ids=torch.zeros(0, dtype=torch.int32, device=dev),
            ins_tiles=torch.zeros(0, dtype=torch.int64, device=dev),
            ins_mu=torch.zeros(0, 3, dtype=torch.float32, device=dev),
            ins_w=torch.zeros(0, dtype=torch.float32, device=dev),
        )

    def wmean(x):
        return torch.dot(w, x.expand_as(w))

    agg = hyp_out.cert_agg
    tape = ScanTape(
        timestamp=batch.t_scan,
        dt_sec=batch.dt_sec,
        fusion_alpha=wmean(hyp_out.alpha),
        power_beta=wmean(hyp_out.beta),
        cond_pose6=wmean(hyp_out.cond_pose6),
        eigmin_pose6=wmean(hyp_out.eigmin_pose6),
        total_trigger_magnitude=hyp_out.total_trigger_mag.sum(),
        cert_exact=agg.exact.amin(),
        cert_frobenius_applied=agg.frobenius_applied.amax(),
        cert_n_triggers=agg.n_triggers.sum(),
        cert_triggers=agg.triggers[0],
        support_ess_total=wmean(agg.ess_total),
        support_frac=wmean(agg.support_frac),
        mismatch_nll_per_ess=wmean(agg.nll_per_ess),
        mismatch_directional_score=wmean(agg.directional_score),
        excitation_dt_effect=wmean(agg.exc_dt_effect),
        excitation_extrinsic_effect=wmean(agg.exc_ex_effect),
        influence_psd_projection_delta=wmean(agg.psd_projection_delta),
        influence_anchor_drift_rho=agg.anchor_drift_rho.amax(),
        influence_dt_scale=wmean(1.0 - hyp_out.s_dt),
        influence_extrinsic_scale=wmean(1.0 - hyp_out.s_ex),
        overconfidence_dt_asymmetry=wmean(hyp_out.sent_dt_asym),
        overconfidence_z_to_xy_ratio=wmean(hyp_out.sent_z_ratio),
        overconfidence_ess_to_excitation=wmean(hyp_out.ess_to_exc),
        hyp_spread=bary.spread_proxy,
        ee_pose_shift_pred=wmean(hyp_out.ee_pose_shift_pred),
        ee_pose_shift_real=wmean(hyp_out.ee_pose_shift_real),
        ee_info_gain_pred=wmean(hyp_out.ee_info_gain_pred),
        ee_info_gain_real=wmean(hyp_out.ee_info_gain_real),
        map_fused_mass=map_tape["fused_mass"],
        map_insert_mass=map_tape["insert_mass"],
        map_evicted_mass=map_tape["evicted_mass"],
        map_n_culled=map_tape["n_culled"],
        map_n_merged=map_tape["n_merged"],
        map_valid_total=map_tape["valid_total"],
        ot_transport_mass=map_tape["ot_transport_mass"],
        ot_marginal_defect_a=map_tape["ot_marginal_defect_a"],
        map_ins_ids=map_tape["ins_ids"],
        map_ins_tiles=map_tape["ins_tiles"],
        map_ins_mu=map_tape["ins_mu"],
        map_ins_w=map_tape["ins_w"],
        io_n_points_valid=(batch.point_weights > 0).to(f).sum(),
        io_n_imu_valid=(batch.imu_stamps > 0).to(f).sum(),
        io_imu_coverage=imu_integration_time(batch.imu_stamps, batch.t_last_scan, batch.t_scan)
        / torch.clamp(batch.dt_sec, min=1e-9),
        io_n_cam_valid=batch.cam_valid.to(f).sum(),
        io_loop_weight=batch.loop_weight.to(f),
        io_point_weight_sum=batch.point_weights.sum().to(f),
    )
    beliefs_new = hyp_out.belief
    if hyp is not None:  # back to this rank's block
        beliefs_new = Belief(*[x[k_lo:k_hi] for x in beliefs_new])
        hyp_weights = hyp_weights[k_lo:k_hi]
    state_new = StepState(
        beliefs=beliefs_new,
        hyp_weights=hyp_weights,
        process_iw=process_iw,
        meas_iw=meas_iw,
        atlas=atlas_new,
        scan_count=state.scan_count + 1,
    )
    return state_new, StepOutput(pose=pose, stamp=batch.t_scan, tape=tape)


def init_state(config: PipelineConfig, stamp: float = 0.0, X_anchor=None, device=None) -> StepState:
    """K_HYP identity-prior beliefs + datasheet IW states (+ empty atlas), on
    `device` (default: the CUDA card)."""
    device = resolve_device(device)
    b0 = identity_prior(stamp, device=device)
    if X_anchor is not None:
        b0 = b0._replace(X_anchor=torch.as_tensor(X_anchor, dtype=BELIEF_DTYPE, device=device))
    beliefs = Belief(*[x.expand((config.k_hyp,) + x.shape).clone() for x in b0])
    return StepState(
        beliefs=beliefs,
        hyp_weights=torch.full((config.k_hyp,), 1.0 / config.k_hyp, dtype=BELIEF_DTYPE, device=device),
        process_iw=iw.datasheet_process_noise(device=device),
        meas_iw=iw.datasheet_measurement_noise(device=device),
        atlas=atlas_mod.empty_atlas(config, device=device) if config.with_map else None,
        scan_count=torch.zeros((), dtype=torch.int32, device=device),
    )


# --- conversion to and from numpy trees (the JAX package's StepState) -----

_STATE_TYPES = {
    "beliefs": Belief,
    "process_iw": iw.ProcessNoiseIW,
    "meas_iw": iw.MeasurementNoiseIW,
    "atlas": atlas_mod.AtlasState,
}


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def state_from_numpy(tree, device=None) -> StepState:
    """StepState from a tree of numpy arrays with the StepState fields
    (e.g. the JAX package's state after np.asarray on every leaf), on
    `device` (default: the CUDA card)."""
    device = resolve_device(device)

    def conv(x):
        return torch.as_tensor(np.array(x), device=device)

    fields = {}
    for name in StepState._fields:
        sub = _get(tree, name)
        if name in _STATE_TYPES:
            cls = _STATE_TYPES[name]
            fields[name] = None if sub is None else cls(**{f: conv(_get(sub, f)) for f in cls._fields})
        else:
            fields[name] = conv(sub)
    return StepState(**fields)


def _map_state(state: StepState, fn) -> StepState:
    fields = {}
    for name in StepState._fields:
        sub = getattr(state, name)
        if name in _STATE_TYPES:
            fields[name] = None if sub is None else type(sub)(*[fn(x) for x in sub])
        else:
            fields[name] = fn(sub)
    return StepState(**fields)


def state_to(state: StepState, device) -> StepState:
    """The same state with every tensor on `device`."""
    return _map_state(state, lambda x: x.to(device))


def state_to_numpy(state: StepState) -> StepState:
    """The same StepState structure with numpy arrays for leaves (field
    names and order match the JAX package's StepState)."""
    return _map_state(state, lambda x: x.detach().cpu().numpy())
