"""Post-run Rerun (.rrd) export of splat_export.npz + trajectory.tum
(counterpart of the JAX package's outputs/rerun_export.py, the reference's
tools/build_rerun_from_splat.py).

`rerun` is an optional dependency that neither this package nor its GPU
hosts ship: `export_rrd(..., require=True)` raises an ImportError naming
it, and `require=False` returns False, so a pipeline can call it
unconditionally.

Logged entities (build_rerun_from_splat.py:40-520):
  world/map/points     coloured points, radius from the Sigma trace
  world/map/ellipsoids per-primitive covariance ellipsoids (top-K by mass)
  world/map/normals    vMF mean-direction arrows (top-K by kappa)
  world/trajectory     line strip of the TUM trajectory
"""

from __future__ import annotations

import numpy as np


def _load_rerun(require: bool):
    try:
        import rerun as rr  # type: ignore

        return rr
    except ImportError as e:
        if require:
            raise ImportError("rerun-sdk is not installed; install it to build .rrd visualizations "
                              "(every other artifact is independent of it)") from e
        return None


def export_rrd(splat_npz_path: str, out_rrd_path: str, trajectory_tum_path: str | None = None,
               top_k_ellipsoids: int = 512, require: bool = True) -> bool:
    """Write the splat map (and trajectory) as a .rrd recording; False when
    the SDK is missing and `require` is False."""
    rr = _load_rerun(require)
    if rr is None:
        return False

    d = np.load(splat_npz_path)
    mu = np.asarray(d["mu_world"], dtype=np.float32)
    Sigma = np.asarray(d["Sigma_world"], dtype=np.float32)
    colors = np.clip(np.asarray(d["colors"], dtype=np.float32), 0.0, 1.0)
    masses = np.asarray(d["masses"], dtype=np.float32)
    normals = np.asarray(d["normals"], dtype=np.float32)
    kappas = np.asarray(d["kappas"], dtype=np.float32)

    rr.init("gcslam_torch", spawn=False)
    rr.save(out_rrd_path)

    radii = np.sqrt(np.maximum(np.trace(Sigma, axis1=1, axis2=2) / 3.0, 1e-8))
    rr.log("world/map/points", rr.Points3D(mu, colors=(colors * 255).astype(np.uint8), radii=radii), static=True)

    top = np.argsort(-masses)[:top_k_ellipsoids]
    evals, evecs = np.linalg.eigh(Sigma[top])
    rr.log("world/map/ellipsoids",
           rr.Ellipsoids3D(centers=mu[top], half_sizes=np.sqrt(np.maximum(evals, 1e-10)),
                           quaternions=_rotmats_to_quats(evecs), colors=(colors[top] * 255).astype(np.uint8)),
           static=True)

    topn = np.argsort(-kappas)[:top_k_ellipsoids]
    rr.log("world/map/normals", rr.Arrows3D(origins=mu[topn], vectors=0.2 * normals[topn]), static=True)

    if trajectory_tum_path is not None:
        traj = np.loadtxt(trajectory_tum_path).reshape(-1, 8)
        rr.log("world/trajectory", rr.LineStrips3D([traj[:, 1:4].astype(np.float32)]), static=True)
    return True


def _rotmats_to_quats(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotation matrices -> (N, 4) xyzw quaternions (w >= 0); an
    improper matrix from eigh (det -1) has its third column flipped first."""
    det = np.linalg.det(R)
    R = R.copy()
    R[det < 0, :, 2] *= -1.0
    q = np.zeros((R.shape[0], 4), dtype=np.float32)
    w = np.sqrt(np.maximum(1.0 + np.trace(R, axis1=1, axis2=2), 1e-12)) / 2.0
    q[:, 3] = w
    q[:, 0] = (R[:, 2, 1] - R[:, 1, 2]) / np.maximum(4 * w, 1e-9)
    q[:, 1] = (R[:, 0, 2] - R[:, 2, 0]) / np.maximum(4 * w, 1e-9)
    q[:, 2] = (R[:, 1, 0] - R[:, 0, 1]) / np.maximum(4 * w, 1e-9)
    n = np.linalg.norm(q, axis=1, keepdims=True)
    return q / np.maximum(n, 1e-9)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m gcslam_torch.outputs.rerun_export", description=__doc__)
    p.add_argument("splat_npz")
    p.add_argument("out_rrd")
    p.add_argument("--trajectory", default=None)
    args = p.parse_args(argv)
    export_rrd(args.splat_npz, args.out_rrd, args.trajectory)
    print(f"wrote {args.out_rrd}")


if __name__ == "__main__":
    main()
