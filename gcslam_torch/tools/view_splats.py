"""Splat-map viewer: renders an exported splat map (outputs/splat_export)
with the EWA + vMF renderer (outputs/rendering) on the CUDA card, or on the
CPU with --cpu, and writes the image as arrays plus a binary PPM.

  python -m gcslam_torch.tools.view_splats results/run1/splat_export.npz \
      [--traj results/run1/trajectory.tum] [--out results/run1/views] [--cpu]

With --traj the camera sits at the trajectory's last pose composed with
the synthetic rig's base->camera extrinsic (the JAX package's viewer puts
the camera at the base pose itself, whose optical z axis then points up);
without it, at an overview vantage above and behind the map's centroid. Writes render_rgb.npy (H, W, 3) float32,
render_depth.npy (H, W) float32, render_rgb.ppm, and map_3d.svg: the JAX
viewer's 3-D overview scatter (its map_3d.png, drawn there with matplotlib,
which the GPU hosts lack) as an SVG of the same points, colours and sizes.
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


OVERVIEW_VIEW = (30.0, -60.0)  # elevation, azimuth in degrees: matplotlib's default 3-D view


def overview_points(mu: np.ndarray, colors: np.ndarray, masses: np.ndarray):
    """What the 3-D overview scatters: positions, colours clipped to [0, 1]
    and marker areas 2 + 40 m / max m (points^2), as the JAX viewer's."""
    return mu, np.clip(colors, 0, 1), 2 + 40 * masses / (masses.max() + 1e-9)


def write_overview_svg(path: str, mu: np.ndarray, colors: np.ndarray, masses: np.ndarray, title: str,
                       size: int = 880) -> None:
    """The overview as an SVG: an orthographic view from OVERVIEW_VIEW,
    points drawn far to near as circles of the scatter's marker area."""
    import html

    xyz, rgb, area = overview_points(mu, colors, masses)
    elev, azim = np.radians(OVERVIEW_VIEW)
    right = np.array([-np.sin(azim), np.cos(azim), 0.0])
    toward = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)])
    up = np.cross(toward, right)
    c = xyz - xyz.mean(0) if len(xyz) else xyz
    u, v, depth = c @ right, c @ up, c @ toward
    scale = 0.8 * size / max(2 * float(np.abs(np.concatenate([u, v])).max(initial=0.0)), 1e-9)
    px, py = size / 2 + scale * u, size / 2 - scale * v
    r = np.sqrt(area) / 2  # marker area in points^2 -> radius
    hexes = ["#%02x%02x%02x" % tuple(int(round(255 * x)) for x in col) for col in rgb]
    lines = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" font-family="sans-serif">',
             f'<text x="{size / 2}" y="20" text-anchor="middle" font-size="14">{html.escape(title)}</text>']
    lines += [f'<circle cx="{px[i]:.2f}" cy="{py[i]:.2f}" r="{r[i]:.3f}" fill="{hexes[i]}"/>'
              for i in np.argsort(depth, kind="stable")]
    lines.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


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
    n = len(mu)
    if n > args.max_splats:
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
    paths = {name: os.path.join(out_dir, name)
             for name in ("render_rgb.npy", "render_depth.npy", "render_rgb.ppm", "map_3d.svg")}
    np.save(paths["render_rgb.npy"], rgb)
    np.save(paths["render_depth.npy"], depth)
    write_ppm(paths["render_rgb.ppm"], rgb)
    write_overview_svg(paths["map_3d.svg"], mu, colors, masses, f"splat map ({n} primitives)")
    print(f"wrote {', '.join(paths.values())}")
    return paths


if __name__ == "__main__":
    main()
