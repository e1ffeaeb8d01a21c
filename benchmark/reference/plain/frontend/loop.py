"""Loop-closure production (counterpart of the JAX package's
frontend/loop.py; numpy only, host side): keyframe store + revisit
detection + coarse point-to-point alignment, feeding the pipeline's
LoopFactor channel.

The factor is consumed by the scan step's always-present Gaussian loop
evidence (weight 0 when absent): detection runs on the host between
steps, consumption is branch-free.

Design notes:
  - keyframes hold DESKEWED body points subsampled to a fixed budget and the
    estimated world pose at creation; matching runs truth-free;
  - the relative transform is estimated coarse-to-fine (3 ICP rounds with
    shrinking trim radius) with a closed-form Kabsch step per round;
  - covariance is scaled by the post-fit residual and match fraction, so a
    bad registration enters the filter weak instead of being gated;
  - a scan-context-style polar height descriptor must also match, which
    rejects geometrically near but structurally different places.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class LoopConfig:
    keyframe_every: int = 10  # scans between keyframes
    max_keyframes: int = 128
    points_per_keyframe: int = 512
    min_index_gap: int = 40  # scans; suppress trivial "loops" to the recent past
    max_revisit_dist_m: float = 1.5
    icp_iters: int = 3
    icp_radii_m: Tuple[float, float, float] = (1.0, 0.5, 0.25)
    min_match_frac: float = 0.3
    max_fit_rms_m: float = 0.35  # absolute post-fit residual acceptance bound
    sigma_trans_floor_m: float = 0.02
    sigma_rot_floor_rad: float = 0.01
    cooldown_scans: int = 20  # between produced factors
    # appearance verification (scan-context-style polar height signature):
    # geometric proximity alone fires false loops under perceptual aliasing
    desc_azimuth_bins: int = 24
    desc_range_rings: int = 8
    desc_max_range_m: float = 10.0
    min_desc_similarity: float = 0.60


@dataclasses.dataclass
class Keyframe:
    index: int
    pose: np.ndarray  # (6,) [trans, rotvec] world (estimated)
    points_body: np.ndarray  # (P, 3)
    pose_cov: np.ndarray = None  # (6,6) filter pose marginal at creation
    descriptor: np.ndarray = None  # (n_az, n_r) polar height signature


def scan_descriptor(points_body: np.ndarray, n_az: int = 24, n_r: int = 8,
                    r_max: float = 10.0) -> np.ndarray:
    """Scan-context-style polar signature: max height per (azimuth, ring)
    cell, zero-mean per scan. Yaw changes ROTATE the azimuth axis, so
    similarity is evaluated under circular shifts (descriptor_similarity)."""
    p = np.asarray(points_body, dtype=np.float64)
    if p.shape[0] == 0:
        return np.zeros((n_az, n_r))
    az = np.arctan2(p[:, 1], p[:, 0])  # [-pi, pi)
    r = np.hypot(p[:, 0], p[:, 1])
    ia = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(int), 0, n_az - 1)
    ir = np.clip((r / r_max * n_r).astype(int), 0, n_r - 1)
    desc = np.full((n_az, n_r), -np.inf)
    np.maximum.at(desc, (ia, ir), p[:, 2])
    desc[~np.isfinite(desc)] = 0.0
    return desc - desc.mean()


def descriptor_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Max cosine similarity over all azimuth (yaw) shifts."""
    na = np.linalg.norm(a) + 1e-12
    nb = np.linalg.norm(b) + 1e-12
    best = -1.0
    for s in range(a.shape[0]):
        best = max(best, float(np.sum(np.roll(a, s, axis=0) * b)) / (na * nb))
    return best


def _yaw_rotvec_to_R(rv: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rv)
    if theta < 1e-12:
        return np.eye(3)
    k = rv / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def _R_to_rotvec(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-8:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * theta / (2.0 * np.sin(theta))


def _subsample(points: np.ndarray, weights: np.ndarray, budget: int) -> np.ndarray:
    ok = weights > 0
    pts = points[ok]
    if pts.shape[0] <= budget:
        return pts
    idx = np.linspace(0, pts.shape[0] - 1, budget).astype(int)
    return pts[idx]


class LoopDetector:
    """Streaming loop-closure producer (one instance per run)."""

    def __init__(self, cfg: LoopConfig = LoopConfig()):
        self.cfg = cfg
        self.keyframes: List[Keyframe] = []
        self._last_factor_index = -(10**9)

    def detect(
        self,
        index: int,
        pose_guess: np.ndarray,  # (6,) current pose estimate (e.g. previous scan)
        points_body: np.ndarray,  # (N, 3) current scan
        point_weights: np.ndarray,  # (N,)
    ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
        """Called BEFORE stepping scan `index`: returns (loop_pose (6,),
        loop_cov (6,6), weight) to inject into this scan's batch, or None."""
        cfg = self.cfg
        pose_guess = np.asarray(pose_guess, dtype=np.float64)
        if index - self._last_factor_index < cfg.cooldown_scans:
            return None
        cur = _subsample(
            np.asarray(points_body, dtype=np.float64),
            np.asarray(point_weights, dtype=np.float64),
            cfg.points_per_keyframe,
        )
        desc_cur = scan_descriptor(
            cur, cfg.desc_azimuth_bins, cfg.desc_range_rings, cfg.desc_max_range_m
        )
        cand = self._find_revisit(index, pose_guess, desc_cur)
        if cand is None:
            return None
        fit = self._register(cur, pose_guess, cand)
        if fit is not None:
            self._last_factor_index = index
        return fit

    def store(
        self,
        index: int,
        pose_est: np.ndarray,  # (6,) the scan's POSTERIOR pose estimate
        points_body: np.ndarray,
        point_weights: np.ndarray,
        pose_cov: np.ndarray = None,  # (6,6) pose marginal at this scan
    ) -> None:
        """Called AFTER stepping scan `index` with its final pose."""
        cfg = self.cfg
        if index % cfg.keyframe_every != 0:
            return
        pts = _subsample(
            np.asarray(points_body, dtype=np.float64),
            np.asarray(point_weights, dtype=np.float64),
            cfg.points_per_keyframe,
        )
        self.keyframes.append(
            Keyframe(index=index, pose=np.asarray(pose_est, dtype=np.float64).copy(),
                     points_body=pts,
                     pose_cov=None if pose_cov is None else np.asarray(pose_cov, dtype=np.float64),
                     descriptor=scan_descriptor(
                         pts, cfg.desc_azimuth_bins, cfg.desc_range_rings,
                         cfg.desc_max_range_m))
        )
        if len(self.keyframes) > cfg.max_keyframes:
            self.keyframes.pop(0)

    # ------------------------------------------------------------------
    def _find_revisit(
        self, index: int, pose: np.ndarray, desc_cur: np.ndarray = None
    ) -> Optional[Keyframe]:
        """OLDEST keyframe within reach whose APPEARANCE also matches: a loop
        target is only as good as the keyframe's own pose, and the oldest
        qualifying keyframe was created when the least drift had accumulated.
        (Nearest-first picks recently drifted keyframes that merely confirm
        the current error.) The descriptor check rejects perceptual-aliasing
        candidates — geometrically near but structurally different scenes."""
        for kf in self.keyframes:  # stored in creation order
            if index - kf.index < self.cfg.min_index_gap:
                continue
            if float(np.linalg.norm(pose[:2] - kf.pose[:2])) >= self.cfg.max_revisit_dist_m:
                continue
            if (desc_cur is not None and kf.descriptor is not None
                    and descriptor_similarity(desc_cur, kf.descriptor)
                    < self.cfg.min_desc_similarity):
                continue
            return kf
        return None

    def _register(
        self, cur_body: np.ndarray, pose_est: np.ndarray, kf: Keyframe
    ) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
        """ICP cur scan (body) onto keyframe cloud (body), initialized from
        the estimated relative pose; returns absolute loop target pose."""
        cfg = self.cfg
        R_c = _yaw_rotvec_to_R(pose_est[3:6])
        R_k = _yaw_rotvec_to_R(kf.pose[3:6])
        # init: T_rel = kf_pose^-1 ∘ cur_pose
        R_rel = R_k.T @ R_c
        t_rel = R_k.T @ (pose_est[:3] - kf.pose[:3])

        tgt = kf.points_body  # (P, 3) keyframe body frame
        match_frac, rms = 0.0, np.inf
        for it in range(cfg.icp_iters):
            radius = cfg.icp_radii_m[min(it, len(cfg.icp_radii_m) - 1)]
            src = cur_body @ R_rel.T + t_rel[None, :]
            # nearest neighbor by brute force (P<=512: 512x512 fine)
            d2 = ((src[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
            nn = np.argmin(d2, axis=1)
            dist = np.sqrt(d2[np.arange(len(nn)), nn])
            ok = dist < radius
            match_frac = float(ok.mean())
            if ok.sum() < 10:
                return None
            a = cur_body[ok]
            b = tgt[nn[ok]]
            # weighted Kabsch
            ca, cb = a.mean(0), b.mean(0)
            H = (a - ca).T @ (b - cb)
            U, S, Vt = np.linalg.svd(H)
            D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
            R_rel = Vt.T @ D @ U.T
            t_rel = cb - R_rel @ ca
            src = a @ R_rel.T + t_rel[None, :]
            rms = float(np.sqrt(((src - b) ** 2).sum(-1).mean()))

        if match_frac < cfg.min_match_frac or rms > cfg.max_fit_rms_m:
            return None
        # absolute target pose: kf_pose ∘ T_rel
        t_abs = kf.pose[:3] + R_k @ t_rel
        R_abs = R_k @ R_rel
        loop_pose = np.concatenate([t_abs, _R_to_rotvec(R_abs)])
        # Covariance from the registration's own statistics: translation
        # sigma ~ rms / sqrt(matches) (mean estimate), rotation sigma ~
        # translation sigma / lever arm (how far the matched points sit from
        # the centroid). Floors keep a perfect fit from claiming zero
        # uncertainty; a poor match_frac widens both continuously.
        n_match = max(int(match_frac * cur_body.shape[0]), 1)
        lever = float(np.linalg.norm(tgt - tgt.mean(0), axis=1).mean()) + 1e-3
        s_t = max(cfg.sigma_trans_floor_m, 2.0 * rms / np.sqrt(n_match)) / max(match_frac, 1e-3)
        s_r = max(cfg.sigma_rot_floor_rad, s_t / lever)
        cov = np.diag([s_t**2] * 3 + [s_r**2] * 3)
        # The target is anchored at the KEYFRAME's estimated pose, so its
        # uncertainty at creation time rides along — without it, a factor
        # against a drifted mid-run keyframe authoritatively confirms the
        # drift instead of correcting it.
        if kf.pose_cov is not None:
            cov = cov + kf.pose_cov
        weight = match_frac
        return loop_pose, cov, weight
