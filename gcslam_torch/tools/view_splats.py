"""Splat-map viewer: renders an exported splat map (outputs/splat_export)
with the EWA + vMF renderer (outputs/rendering) on the CUDA card, or on the
CPU with --cpu, and writes the image as arrays plus a binary PPM.

  python -m gcslam_torch.tools.view_splats results/run1/splat_export.npz \
      [--traj results/run1/trajectory.tum] [--out results/run1/views] [--cpu]

With --traj the camera sits at the trajectory's last pose composed with
the synthetic rig's base->camera extrinsic (the JAX package's viewer puts
the camera at the base pose itself, whose optical z axis then points up);
without it, at an overview vantage above and behind the map's centroid. Writes render_rgb.npy (H, W, 3) float32,
render_depth.npy (H, W) float32 and render_rgb.ppm.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

RENDER_SIZE = dict(width=480, height=360, fx=360.0, fy=360.0)


def overview_pose(mu: np.ndarray) -> np.ndarray:
    """Camera->world pose [trans, rotvec]: 8 m behind (-y) and 3 m above the
    centroid, looking at it (optical z forward, x right, y down). The JAX
    package's viewer uses the same eye with the fixed rotvec (0.4, 0, pi/2),
    whose optical axis points up, away from the map: its renders are empty."""
    import torch

    from gcslam_torch.ops import se3

    c = mu.mean(0)
    eye = c + np.array([0.0, -8.0, 3.0])
    z = (c - eye) / np.linalg.norm(c - eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    R_wc = np.stack([x, np.cross(z, x), z], axis=1)
    return np.concatenate([eye, se3.so3_log(torch.as_tensor(R_wc)).numpy()])


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Binary PPM (P6) of an (H, W, 3) image in [0, 1]."""
    img = np.clip(np.round(np.asarray(rgb) * 255.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6 {img.shape[1]} {img.shape[0]} 255\n".encode())
        f.write(img.tobytes())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("splats")
    p.add_argument("--traj", default=None, help="TUM trajectory: render from the last pose")
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true", help="render on the CPU (default: the CUDA card)")
    p.add_argument("--max-splats", type=int, default=4096)
    args = p.parse_args(argv)

    import torch

    from gcslam_torch.frontend.synthetic import T_BASE_CAM
    from gcslam_torch.ops import se3
    from gcslam_torch.outputs.rendering import RenderParams, render_splats
    from gcslam_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    out_dir = args.out or os.path.join(os.path.dirname(args.splats), "views")
    os.makedirs(out_dir, exist_ok=True)
    sp = np.load(args.splats)
    mu, Sigma = sp["mu_world"], sp["Sigma_world"]
    etas, colors, masses = sp["etas"], sp["colors"], sp["masses"]
    if len(mu) > args.max_splats:
        top = np.argsort(-masses, kind="stable")[: args.max_splats]
        mu, Sigma, etas, colors, masses = mu[top], Sigma[top], etas[top], colors[top], masses[top]

    if args.traj:
        from gcslam_torch.outputs.tum import read_tum

        _, poses = read_tum(args.traj)
        cam = se3.se3_compose(torch.as_tensor(poses[-1]), torch.as_tensor(T_BASE_CAM)).numpy()
    else:
        cam = overview_pose(mu)

    def t(x):
        return torch.as_tensor(x, device=device)

    rgb, depth = render_splats(t(mu), t(Sigma), t(etas), t(colors), t(masses), t(cam),
                               RenderParams(**RENDER_SIZE))
    rgb, depth = rgb.cpu().numpy(), depth.cpu().numpy()
    paths = {name: os.path.join(out_dir, name) for name in ("render_rgb.npy", "render_depth.npy", "render_rgb.ppm")}
    np.save(paths["render_rgb.npy"], rgb)
    np.save(paths["render_depth.npy"], depth)
    write_ppm(paths["render_rgb.ppm"], rgb)
    print(f"wrote {', '.join(paths.values())}")
    return paths


if __name__ == "__main__":
    main()
