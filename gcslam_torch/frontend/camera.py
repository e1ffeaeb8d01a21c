"""Camera feature extraction + LiDAR depth evidence — the visual frontend
(counterpart of the JAX package's frontend/camera.py, pure route).

Harris corners by filters (3x3 Sobel, 5x5 box, (2r+1)^2 max-pool NMS,
top-K), a weighted plane fit of the depth image around each corner, LiDAR
depth evidence (Route A robust image-space mean + Route B ray-plane
intersection) fused with the camera depth as a product of experts, then the
closed-form 3x3 backprojection covariance lifted to a 3-D Gaussian in
information form plus a vMF appearance lobe along the viewing ray. Fixed
N_FEAT budget with validity masks; every function is plain tensor code on
the device of its inputs.

The Sobel and box filters are shifted sums over the zero-padded image in
tap order, not `conv2d`: on the card a float32 `conv2d` goes to cuDNN, whose
algorithm (and TF32 setting) picks the summation order, so the corner
scores — and the top-K among near-equal scores — could change between
cards and runs. Shifted sums give the same order everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gcslam_torch import constants as C
from gcslam_torch.ops import linalg, se3
from gcslam_torch.ops.association import topk_lowest_index
from gcslam_torch.utils.device import resolve_device
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, POINT_DTYPE


@dataclasses.dataclass(frozen=True)
class PinholeIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def K(self):
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]])


class CameraFeatures(NamedTuple):
    """Fixed-budget camera feature set."""

    uv: torch.Tensor  # (N_FEAT, 2) pixel coords
    depth: torch.Tensor  # (N_FEAT,) fused depth (m)
    Lambdas: torch.Tensor  # (N_FEAT, 3, 3) 3-D info-form precision (camera frame)
    thetas: torch.Tensor  # (N_FEAT, 3)
    etas: torch.Tensor  # (N_FEAT, B, 3) vMF appearance lobes
    weights: torch.Tensor  # (N_FEAT,) reliability
    colors: torch.Tensor  # (N_FEAT, 3)
    valid: torch.Tensor  # (N_FEAT,) bool


def _conv2(img: torch.Tensor, k) -> torch.Tensor:
    """SAME-padded 2-D cross-correlation of (H, W) with the (kh, kw) nested
    list `k` (odd sizes): shifted sums in row-major tap order, zero taps
    skipped (adding 0 * x leaves the sum as it is)."""
    kh, kw = len(k), len(k[0])
    H, W = img.shape
    p = F.pad(img, (kw // 2, kw // 2, kh // 2, kh // 2))
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            if k[i][j] != 0.0:
                out = out + k[i][j] * p[i:i + H, j:j + W]
    return out


_SOBEL_X = [[-1 / 8, 0.0, 1 / 8], [-2 / 8, 0.0, 2 / 8], [-1 / 8, 0.0, 1 / 8]]
_SOBEL_Y = [list(r) for r in zip(*_SOBEL_X)]
_BOX5 = [[1 / 25] * 5 for _ in range(5)]


def harris_corners(gray: torch.Tensor, n_feat: int, k: float = 0.04,
                   nms_radius: int = 2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harris corner detection by filters.

    Returns (uv (n_feat, 2) float32, score (n_feat,), valid (n_feat,) bool).
    """
    g = gray.to(POINT_DTYPE)
    Ix = _conv2(g, _SOBEL_X)
    Iy = _conv2(g, _SOBEL_Y)
    Sxx = _conv2(Ix * Ix, _BOX5)
    Syy = _conv2(Iy * Iy, _BOX5)
    Sxy = _conv2(Ix * Iy, _BOX5)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    R = det - k * tr * tr

    # (2r+1)^2 max-pool NMS (max_pool2d pads with -inf, as reduce_window
    # does): keep local maxima with a positive response
    w = 2 * nms_radius + 1
    Rmax = F.max_pool2d(R[None, None], w, stride=1, padding=nms_radius)[0, 0]
    is_peak = (R >= Rmax) & (R > 0)
    # suppress a border band (patch ops need margins)
    H, W = R.shape
    ys = torch.arange(H, device=R.device)[:, None]
    xs = torch.arange(W, device=R.device)[None, :]
    margin = 4
    inb = (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)
    score = torch.where(is_peak & inb, R, -torch.inf)

    # many -inf ties: the lowest index first, as lax.top_k
    top, idx = topk_lowest_index(score.reshape(-1), n_feat)
    v = idx // W
    u = idx % W
    valid = torch.isfinite(top) & (top > 0)
    uv = torch.stack([u, v], dim=-1).to(POINT_DTYPE)
    return uv, torch.where(valid, top, 0.0), valid


def _gather_patch(img: torch.Tensor, uv: torch.Tensor, r: int) -> torch.Tensor:
    """(n, (2r+1)^2) patches around integer uv (clamped), row-major."""
    H, W = img.shape
    d = torch.arange(-r, r + 1, device=img.device)
    uu = torch.clamp(uv[:, 0, None, None].to(torch.int64) + d[None, None, :], 0, W - 1)
    vv = torch.clamp(uv[:, 1, None, None].to(torch.int64) + d[None, :, None], 0, H - 1)
    return img[vv, uu].reshape(uv.shape[0], -1)


def depth_plane_fit(depth: torch.Tensor, uv: torch.Tensor, r: int = 2,
                    eps: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local weighted plane fit z(u, v) = a du + b dv + c on a (2r+1)^2 patch.

    Returns (z_fit (n,), grad (n, 2) = (a, b), resid_var (n,)); invalid
    (zero) depths get zero weight."""
    w_side = 2 * r + 1
    patch = _gather_patch(depth, uv, r)  # (n, P)
    d = torch.arange(-r, r + 1, dtype=patch.dtype, device=patch.device)
    du = d.repeat(w_side)
    dv = d.repeat_interleave(w_side)
    w = (patch > 0).to(patch.dtype)

    A = torch.stack([du.expand_as(patch), dv.expand_as(patch), torch.ones_like(patch)], dim=-1)  # (n, P, 3)
    Aw = A * w[..., None]
    AtWA = Aw.transpose(-1, -2) @ A + eps * torch.eye(3, dtype=patch.dtype, device=patch.device)
    AtWz = (Aw * patch[..., None]).sum(1)
    coef = linalg.solve3x3(AtWA, AtWz)  # (n, 3) = (a, b, c)
    z_fit = coef[:, 2]
    resid = patch - (A @ coef[:, :, None])[..., 0]
    m = torch.clamp(w.sum(1), min=1.0)
    resid_var = (w * resid * resid).sum(1) / m
    return z_fit, coef[:, :2], resid_var


def backprojection_covariance(
    uv: torch.Tensor, z: torch.Tensor, sigma_z_sq: torch.Tensor,
    intr: PinholeIntrinsics, sigma_px: float = 0.7,
) -> torch.Tensor:
    """Closed-form 3x3 covariance of p = z K^{-1} (u, v, 1):
    Sigma = J diag(s_px^2, s_px^2, s_z^2) J^T with J = dp / d(u, v, z)."""
    x = (uv[:, 0] - intr.cx) / intr.fx
    y = (uv[:, 1] - intr.cy) / intr.fy
    zero = torch.zeros_like(z)
    J = torch.stack(
        [
            torch.stack([z / intr.fx, zero, x.to(z.dtype)], -1),
            torch.stack([zero, z / intr.fy, y.to(z.dtype)], -1),
            torch.stack([zero, zero, torch.ones_like(z)], -1),
        ],
        dim=-2,
    )  # (n, 3, 3)
    D = torch.stack([torch.full_like(z, sigma_px**2), torch.full_like(z, sigma_px**2), sigma_z_sq], -1)
    return (J * D[:, None, :]) @ J.transpose(-1, -2)


def backproject(uv: torch.Tensor, z: torch.Tensor, intr: PinholeIntrinsics) -> torch.Tensor:
    x = (uv[:, 0] - intr.cx) / intr.fx
    y = (uv[:, 1] - intr.cy) / intr.fy
    return torch.stack([x * z, y * z, z.to((x * z).dtype)], dim=-1)


# ---------------------------------------------------------------------------
# LiDAR -> camera depth evidence (Route A + Route B) and PoE fusion
# ---------------------------------------------------------------------------


def lidar_depth_evidence(
    uv: torch.Tensor,  # (n, 2) feature pixels
    lidar_cam: torch.Tensor,  # (M, 3) LiDAR points in CAMERA frame
    lidar_w: torch.Tensor,  # (M,)
    intr: PinholeIntrinsics,
    radius_px: float = 6.0,
    eps: float = 1e-9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature LiDAR depth evidence (lambda_z, z_l), dense over all
    (feature, point) pairs:

      Route A — project LiDAR into the image; Gaussian-weight points by
      pixel distance to the feature; robust (MAD-downweighted) mean depth.
      Route B — weighted plane fit of the same neighbourhood in 3-D,
      intersected with the feature ray.

    The two add as a product of experts; features with no LiDAR support get
    lambda -> 0 continuously (never a gate). The plane normal's sign is
    free (eigenvector), and z_b = d / (n . ray) does not depend on it."""
    z = torch.clamp(lidar_cam[:, 2], min=eps)
    u_l = intr.fx * lidar_cam[:, 0] / z + intr.cx
    v_l = intr.fy * lidar_cam[:, 1] / z + intr.cy
    in_front = (lidar_cam[:, 2] > 0.1).to(lidar_cam.dtype) * lidar_w

    d2 = (uv[:, 0:1] - u_l[None, :]) ** 2 + (uv[:, 1:2] - v_l[None, :]) ** 2  # (n, M)
    w_px = torch.exp(-0.5 * d2 / radius_px**2) * in_front[None, :]

    # Route A: robust weighted depth. With float64 pixels (the native
    # route's) the weights are float64 and the float32 LiDAR operands are
    # promoted, as JAX promotes a mixed product.
    zw = z.to(w_px.dtype)
    wsum = w_px.sum(1) + eps
    z_mean = w_px @ zw / wsum
    dev = (z[None, :] - z_mean[:, None]).abs()
    mad = (w_px * dev).sum(1) / wsum + 1e-3
    w_rob = w_px / (1.0 + (dev / (1.4826 * mad[:, None])) ** 2)
    wsum_r = w_rob.sum(1) + eps
    z_a = w_rob @ zw / wsum_r
    var_a = torch.clamp((w_rob @ (z * z).to(w_px.dtype)) / wsum_r - z_a**2, min=1e-6)  # E[z^2] - E[z]^2
    lam_a = wsum_r / (wsum_r + 1.0) / var_a  # support-scaled precision

    # Route B: plane fit p.n = d of the neighbourhood; depth where the
    # feature ray ((x, y, 1) z) crosses the plane
    x_r = (uv[:, 0] - intr.cx) / intr.fx
    y_r = (uv[:, 1] - intr.cy) / intr.fy
    mean_p = (w_rob @ lidar_cam.to(w_px.dtype)) / wsum_r[:, None]  # (n, 3)
    diff = lidar_cam[None, :, :] - mean_p[:, None, :]  # (n, M, 3)
    cov = (w_rob[..., None] * diff).transpose(-1, -2) @ diff / wsum_r[:, None, None]
    cov = linalg.sym(cov) + 1e-6 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    evals, evecs = linalg.eigh_3x3(cov)
    n_pl = evecs[:, :, 0]
    d_pl = (n_pl * mean_p).sum(-1)
    denom = n_pl[:, 0] * x_r + n_pl[:, 1] * y_r + n_pl[:, 2]
    z_b = d_pl / torch.where(denom.abs() > 1e-3, denom, 1e-3)
    planarity = 1.0 - evals[:, 0] / (evals[:, 2] + eps)  # 1 = perfectly planar
    z_b_ok = (z_b > 0.1) & (denom.abs() > 1e-2)
    lam_b = torch.where(z_b_ok, planarity * wsum_r / (wsum_r + 1.0) / torch.clamp(evals[:, 0], min=1e-6), 0.0)

    # PoE of the two routes
    lam = lam_a + lam_b
    z_f = (lam_a * z_a + lam_b * torch.where(z_b_ok, z_b, 0.0)) / (lam + eps)
    return lam, z_f


def extract_camera_features(
    gray: torch.Tensor,  # (H, W) float
    depth: torch.Tensor,  # (H, W) float metres, 0 = invalid
    rgb: torch.Tensor,  # (H, W, 3) float [0, 1]
    intr: PinholeIntrinsics,
    lidar_cam: torch.Tensor | None = None,  # (M, 3) points in camera frame
    lidar_w: torch.Tensor | None = None,
    n_feat: int = C.N_FEAT,
) -> CameraFeatures:
    """Full visual frontend: corners -> camera depth + covariance -> LiDAR
    depth evidence -> PoE fusion -> 3-D Gaussian info form + vMF lobe."""
    uv, score, valid = harris_corners(gray, n_feat)
    z_cam, _, resid_var = depth_plane_fit(depth, uv)
    return _lift(uv, score, valid, z_cam, resid_var, rgb, intr, lidar_cam, lidar_w, n_feat, gray.dtype)


def extract_camera_features_native(
    gray: np.ndarray,  # (H, W) float [0, 1] or uint8, on the host
    depth: np.ndarray,  # (H, W) float metres, 0 = invalid
    rgb: np.ndarray,  # (H, W, 3) float [0, 1]
    intr: PinholeIntrinsics,
    lidar_cam=None,  # (M, 3) points in camera frame (array or tensor)
    lidar_w=None,
    n_feat: int = C.N_FEAT,
    device=None,
) -> CameraFeatures:
    """The bag route of the visual frontend: corners, robust depth and the
    plane fit run in C++ on the host (the bag decoder's
    gcslam_visual_features, the reference's src/visual_feature_node.cpp
    stage); the LiDAR depth evidence, PoE fusion and Gaussian/vMF lift run
    here in torch on `device` (default: the CUDA card), as in the JAX
    package's extract_camera_features_native."""
    from gcslam_torch.frontend import native

    g8 = np.asarray(gray)
    if g8.dtype != np.uint8:
        g8 = np.clip(np.asarray(gray, dtype=np.float64) * 255.0, 0, 255).astype(np.uint8)
    n, uv_n, score_n, z_n, zvar_n, _normal, _gray01 = native.visual_features(
        g8, np.asarray(depth, np.float32), max_feat=n_feat)

    dev = resolve_device(device)
    f = BELIEF_DTYPE

    def rows(x, fill: float) -> torch.Tensor:
        out = torch.full((n_feat,) + x.shape[1:], fill, dtype=f, device=dev)
        out[:n] = torch.as_tensor(x[:n], device=dev).to(f)
        return out

    valid = torch.zeros(n_feat, dtype=torch.bool, device=dev)
    valid[:n] = True
    if lidar_cam is not None:
        lidar_cam = torch.as_tensor(lidar_cam, device=dev)
        lidar_w = None if lidar_w is None else torch.as_tensor(lidar_w, device=dev)
    return _lift(rows(uv_n, 0.0), rows(score_n, 0.0), valid, rows(z_n, 0.0), rows(zvar_n, 1.0),
                 torch.as_tensor(np.asarray(rgb), device=dev), intr, lidar_cam, lidar_w, n_feat, f)


def _lift(uv, score, valid, z_cam, resid_var, rgb, intr: PinholeIntrinsics, lidar_cam, lidar_w, n_feat: int,
          evidence_dtype) -> CameraFeatures:
    """Both routes' lift of the corners: camera depth and its variance, the
    LiDAR depth evidence (cast to `evidence_dtype`), PoE depth fusion, the
    3-D Gaussian in information form, the vMF lobe and the colour."""
    f = BELIEF_DTYPE
    z_valid = z_cam > 0.05
    sigma_z_sq = resid_var + 0.0025 * z_cam**2 + 1e-6  # stereo-like growth

    lam_z_cam = torch.where(z_valid, 1.0 / sigma_z_sq, 0.0)
    if lidar_cam is not None:
        w_l = torch.ones(lidar_cam.shape[0], device=lidar_cam.device) if lidar_w is None else lidar_w
        lam_z_l, z_l = lidar_depth_evidence(uv, lidar_cam.to(POINT_DTYPE), w_l.to(POINT_DTYPE), intr)
        lam_z_l = lam_z_l.to(evidence_dtype)
        z_l = z_l.to(evidence_dtype)
    else:
        lam_z_l = torch.zeros_like(z_cam)
        z_l = torch.zeros_like(z_cam)

    # PoE depth fusion: lambda_f = lambda_c + lambda_l
    lam_f = lam_z_cam + lam_z_l
    z_f = (lam_z_cam * z_cam + lam_z_l * z_l) / (lam_f + 1e-12)
    has_depth = lam_f > 1e-6
    z_f = torch.where(has_depth, z_f, 1.0)

    Sigma = backprojection_covariance(uv, z_f, 1.0 / (lam_f + 1e-12), intr)
    Lam = linalg.inv3x3(Sigma.to(f), eps=1e-9)
    p_cam = backproject(uv, z_f, intr).to(f)
    theta = se3.mv(Lam, p_cam)

    # vMF appearance: lobe 0 along the viewing ray, kappa from corner-score
    # saturation (association consumes only directions and kappas)
    ray = p_cam / (torch.linalg.vector_norm(p_cam, dim=-1, keepdim=True) + 1e-12)
    kappa_app = 5.0 * score / (score + score.mean() + 1e-12)
    etas = torch.zeros((n_feat, C.VMF_N_LOBES, 3), dtype=f, device=p_cam.device)
    etas[:, 0, :] = kappa_app[:, None] * ray

    # colours from the rgb image at the corner
    ui = torch.clamp(uv[:, 0].to(torch.int64), 0, rgb.shape[1] - 1)
    vi = torch.clamp(uv[:, 1].to(torch.int64), 0, rgb.shape[0] - 1)
    colors = rgb[vi, ui].to(f)

    ok = valid & has_depth
    weights = torch.where(ok, score / (score + score.mean() + 1e-12), 0.0).to(f)
    okf = ok.to(f)
    return CameraFeatures(
        uv=uv.to(f),
        depth=z_f.to(f),
        Lambdas=Lam * okf[:, None, None],
        thetas=theta * okf[:, None],
        etas=etas * okf[:, None, None],
        weights=weights,
        colors=colors,
        valid=ok,
    )


def features_to_base_frame(feats: CameraFeatures, T_base_cam) -> CameraFeatures:
    """Camera-frame Gaussians and lobes -> base frame (the batch's camera
    slice is consumed in base coordinates)."""
    dev = feats.Lambdas.device
    T = torch.as_tensor(T_base_cam, dtype=BELIEF_DTYPE, device=dev)
    R = se3.so3_exp(T[3:6])
    t = T[:3]
    Lam_b = R @ feats.Lambdas @ R.T
    mu_c = linalg.solve3x3(feats.Lambdas, feats.thetas, eps=1e-9)
    mu_b = mu_c @ R.T + t[None, :]
    theta_b = se3.mv(Lam_b, mu_b)
    eta_b = feats.etas @ R.T
    okf = feats.valid.to(Lam_b.dtype)
    return feats._replace(Lambdas=Lam_b * okf[:, None, None], thetas=theta_b * okf[:, None], etas=eta_b)
