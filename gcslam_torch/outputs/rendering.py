"""Gaussian-splat renderer: EWA elliptical splatting with multi-lobe vMF
view-dependent shading (counterpart of the JAX package's
outputs/rendering.py and the projection half of rendering_pallas.py).

  - EWA: each primitive's 3-D Gaussian is pushed through the pinhole into a
    2-D covariance; a pixel's weight is exp(-0.5 d^T Sigma2d^-1 d), cut to
    zero at log_clip;
  - multi-lobe vMF shading I(v) ~ sum_b exp(eta_b . v) (no spherical
    harmonics);
  - world-space fBm value noise for a stable surface texture;
  - front-to-back alpha compositing in depth order
    (`outputs/raster.composite_splats`: the CUDA kernel on the card, the
    plain loop on the CPU).

The projection runs in float32, as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gcslam_torch.ops import linalg, se3
from gcslam_torch.ops.association import topk_lowest_index
from gcslam_torch.outputs.raster import ScreenSplats, composite_splats
from gcslam_torch.utils.device import resolve_device
from gcslam_torch.utils.dtypes import POINT_DTYPE as F32


class RenderParams(NamedTuple):
    width: int = 320
    height: int = 240
    fx: float = 240.0
    fy: float = 240.0
    alpha_scale: float = 0.8
    noise_amp: float = 0.15
    log_clip: float = -8.0  # exp(-8) footprint cutoff (log-domain clipping)


def _fbm_value_noise(p: torch.Tensor, octaves: int = 3) -> torch.Tensor:
    """World-space fBm value noise from a smooth lattice hash (no gradients).
    The hash |sin(s) * 43758.5453| mod 1 scales one ulp of sin(s) by ~4e4,
    so two correct sin implementations give noise values ~3e-3 apart."""
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    amp = 1.0
    freq = 2.0

    def h(c):
        s = c[..., 0] * 127.1 + c[..., 1] * 311.7 + c[..., 2] * 74.7
        return torch.abs(torch.sin(s) * 43758.5453) % 1.0

    for _ in range(octaves):
        q = p * freq
        qi = torch.floor(q)
        qf = q - qi
        w = qf * qf * (3.0 - 2.0 * qf)  # smoothstep
        v = 0.0
        for dx in (0.0, 1.0):
            for dy in (0.0, 1.0):
                for dz in (0.0, 1.0):
                    corner = qi + torch.tensor([dx, dy, dz], dtype=p.dtype, device=p.device)
                    wx = w[..., 0] if dx else (1 - w[..., 0])
                    wy = w[..., 1] if dy else (1 - w[..., 1])
                    wz = w[..., 2] if dz else (1 - w[..., 2])
                    v = v + h(corner) * wx * wy * wz
        out = out + amp * (v - 0.5)
        amp *= 0.5
        freq *= 2.0
    return out


def prepare_screen_splats(mu_world, Sigma_world, etas, colors, masses, cam_pose,
                          params: RenderParams = RenderParams()) -> ScreenSplats:
    """Project, shade and depth-sort the splats (camera->world pose
    cam_pose = [trans, rotvec]); float32 screen parameters.

    `radius` is the clip radius sqrt(-2 log_clip lambda_max(Sigma2d)) plus
    one pixel for rounding: beyond it q < log_clip and the weight is exactly
    0, so a compositor that skips a splat outside it computes the same image
    as one that does not. (The TPU kernel's 3-sigma radius drops weights out
    to 4 sigma at log_clip = -8, and its result depends on its tile size.)"""
    dev = mu_world.device
    R_wc = se3.so3_exp(cam_pose[3:6].to(F32))
    t_wc = cam_pose[:3].to(F32)

    # world -> camera
    mu_c = (mu_world.to(F32) - t_wc[None, :]) @ R_wc  # (P, 3)
    z = mu_c[:, 2]
    in_front = z > 0.1
    z_safe = torch.clamp(z, min=0.1)

    # EWA: the 3-D covariance through the pinhole Jacobian
    Sig_c = R_wc.T @ Sigma_world.to(F32) @ R_wc
    x, y = mu_c[:, 0], mu_c[:, 1]
    zero = torch.zeros_like(z)
    J = torch.stack(
        [
            torch.stack([params.fx / z_safe, zero, -params.fx * x / z_safe**2], -1),
            torch.stack([zero, params.fy / z_safe, -params.fy * y / z_safe**2], -1),
        ],
        dim=-2,
    )  # (P, 2, 3)
    Sig2 = J @ Sig_c @ J.transpose(-1, -2) + 0.3 * torch.eye(2, dtype=F32, device=dev)
    s00, s01, s10, s11 = Sig2[:, 0, 0], Sig2[:, 0, 1], Sig2[:, 1, 0], Sig2[:, 1, 1]
    det2 = torch.clamp(s00 * s11 - s01 * s10, min=1e-12)
    inv2 = torch.stack([s11 / det2, -0.5 * (s01 + s10) / det2, s00 / det2], dim=-1)
    lam_max = 0.5 * (s00 + s11 + torch.sqrt(torch.clamp((s00 - s11) ** 2 + (s01 + s10) ** 2, min=0.0)))
    radius = torch.sqrt(max(-2.0 * params.log_clip, 0.0) * lam_max) + 1.0

    u0 = params.fx * x / z_safe + params.width / 2.0
    v0 = params.fy * y / z_safe + params.height / 2.0

    # vMF view-dependent shading: I(v) ~ sum_b exp(eta_b . v)
    view = mu_c / torch.clamp(torch.linalg.vector_norm(mu_c, dim=-1, keepdim=True), min=1e-6)
    view_w = view @ R_wc.T  # back to world for the world-frame lobes
    e = etas.to(F32)
    dots = se3.mv(e, -view_w)  # (P, B)
    kap = torch.linalg.vector_norm(e, dim=-1)
    shade = torch.exp(dots - kap).sum(-1) / float(max(e.shape[1], 1))
    shade = 0.4 + 0.6 * torch.clamp(shade, 0.0, 1.0)

    # world-space fBm texture modulation
    noise = _fbm_value_noise(mu_world.to(F32))
    albedo = torch.clamp(colors.to(F32) * (1.0 + params.noise_amp * noise[:, None]), 0.0, 1.0)
    rgb_p = albedo * shade[:, None]

    m = masses.to(F32)
    alpha = params.alpha_scale * m / (m + 1.0) * in_front.to(F32)

    order = torch.argsort(z, stable=True)
    return ScreenSplats(*[t[order].contiguous() for t in (u0, v0, inv2, rgb_p, alpha, z, radius)])


def render_splats(mu_world, Sigma_world, etas, colors, masses, cam_pose,
                  params: RenderParams = RenderParams()) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (rgb (H, W, 3) in [0, 1], depth (H, W)) on the device of the
    splats: the CUDA kernel composites on the card, the plain loop on the
    CPU. Depth is the coverage-weighted mean, divided by max(1 - T, 1e-6)."""
    s = prepare_screen_splats(mu_world, Sigma_world, etas, colors, masses, cam_pose, params)
    rgb, depth, T = composite_splats(s, params.height, params.width, params.log_clip)
    cover = torch.clamp(1.0 - T, min=1e-6)
    return torch.clamp(rgb, 0.0, 1.0), depth / cover


def atlas_splats(atlas, max_splats: int = 4096):
    """The top-mass splats of an atlas: (mu, Sigma, etas, rgb, masses), with
    invalid slots at zero mass."""
    T, M = atlas.weights.shape
    w = torch.where(atlas.valid, atlas.weights, -torch.inf).reshape(-1)
    k = min(max_splats, T * M)
    top, idx = topk_lowest_index(w, k)
    ti, si = idx // M, idx % M
    Lam = atlas.Lambdas[ti, si].to(F32)
    Sigma = linalg.inv3x3(Lam, eps=1e-6)
    th = atlas.thetas[ti, si].to(F32)
    mu = se3.mv(Sigma, th)
    masses = torch.where(torch.isfinite(top), atlas.weights.reshape(-1)[idx], 0.0)
    return mu, Sigma, atlas.etas[ti, si], atlas.rgb[ti, si], masses


def render_atlas(atlas, cam_pose, params: RenderParams = RenderParams(), max_splats: int = 4096,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render the top-mass splats of an atlas from the camera->world pose
    cam_pose, on `device` (default: the CUDA card)."""
    device = resolve_device(device)
    splats = [x.to(device) for x in atlas_splats(atlas, max_splats)]
    return render_splats(*splats, torch.as_tensor(cam_pose).to(device), params)
