"""The port's f32-belief mode (GCSLAM_BELIEF_DTYPE=float32, the JAX
package's production configuration) held to the port's own f64 run by the
three gates of tests/test_precision.py (the JAX package's f32 mode on the
SMALL world is held in tests/test_torch_precision_jax.py).

The dtype binds when the package is imported, so every run is a child
process with the variable set (one torch thread each); a gate's f32 and
f64 children run at once.

Gates, as the JAX package's:
  1. tracking with epoch-scale stamps (map on): finite, last xy error
     < 0.5 m, RMSE within 2x + 3 cm of f64; stamps stay f64;
  2. aggressive motion (1.2 rad/s yaw, 10x drift): no NonFiniteEvidence
     rejection, fusion alpha and power beta within their bounds, RMSE
     within 2x + 5 cm of f64;
  3. a 1e-4-covariance loop factor against a drifted prior: absorbed (last
     xy error < 0.3 m), no rejection, within 2x + 5 cm of f64."""

import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PORT = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, TIME_DTYPE
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models import runner
from gcslam_torch.frontend.synthetic import generate, SyntheticConfig
from gcslam_torch.ops.certs import TRIGGERS

MODE = os.environ["GCSLAM_PRECISION_TEST_MODE"]
if MODE == "track":
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
                         surfel_voxel_size_m=0.5)
    run = generate(SyntheticConfig(n_scans=30, n_points=512, t0=1.7e9), device="cpu")
    batches = run.batches
elif MODE == "stress":
    cfg = PipelineConfig(with_map=False)
    run = generate(SyntheticConfig(n_scans=40, n_points=256, t0=1.7e9, speed_mps=1.5, turn_rate=1.2,
                                   odom_drift_pos_per_m=0.2, odom_drift_yaw_per_m=0.1, seed=11), device="cpu")
    batches = run.batches
elif MODE == "loop":
    cfg = PipelineConfig(with_map=False)
    run = generate(SyntheticConfig(n_scans=24, n_points=256, t0=1.7e9, odom_drift_pos_per_m=0.5,
                                   odom_drift_yaw_per_m=0.15, seed=9), device="cpu")
    batches = []
    for i, b in enumerate(run.batches):
        if i >= 18:
            b = b._replace(loop_pose=torch.as_tensor(run.gt_poses[i], dtype=b.loop_pose.dtype),
                           loop_cov=torch.as_tensor(np.diag([1e-4] * 3 + [1e-5] * 3), dtype=b.loop_cov.dtype),
                           loop_weight=torch.ones((), dtype=b.loop_weight.dtype))
        batches.append(b)
else:  # "small": the JAX comparison (tests/test_torch_precision_jax.py)
    cfg = PipelineConfig(with_map=False)
    run = generate(SyntheticConfig(n_scans=10, n_points=512), device="cpu")
    batches = run.batches

state, out = runner.run_bag(batches, cfg, device="cpu")
poses = out.pose.numpy()
err = np.linalg.norm(poses[:, :2] - run.gt_poses[: poses.shape[0], :2], axis=1)
masks = out.tape.cert_triggers.numpy().astype(np.int64)
alpha, beta = out.tape.fusion_alpha.numpy(), out.tape.power_beta.numpy()
print(json.dumps({
    "dtype": str(BELIEF_DTYPE).replace("torch.", ""),
    "time_dtype": str(TIME_DTYPE).replace("torch.", ""),
    "pose_dtype": str(out.pose.dtype).replace("torch.", ""),
    "poses": poses.astype(np.float64).tolist(),
    "finite": bool(np.all(np.isfinite(poses))),
    "xy_rmse": float(np.sqrt((err ** 2).mean())),
    "xy_last": float(err[-1]),
    "n_nonfinite_rejections": int(np.sum((masks & TRIGGERS["NonFiniteEvidence"]) != 0)),
    "alpha_ok": bool(np.all(np.isfinite(alpha)) and np.all(alpha > 0)),
    "beta_ok": bool(np.all(np.isfinite(beta)) and np.all(beta >= 0) and np.all(beta <= 1.0 + 1e-5)),
}))
"""


def _run(code: str, belief_dtype: str, mode: str = "") -> dict:
    """One child process with GCSLAM_BELIEF_DTYPE set; its JSON line."""
    env = dict(os.environ, GCSLAM_BELIEF_DTYPE=belief_dtype, GCSLAM_PRECISION_TEST_MODE=mode)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def pair(mode: str):
    """The f32 and f64 runs of a mode, as two concurrent children."""
    with ThreadPoolExecutor(2) as pool:
        return tuple(pool.map(lambda dt: _run(_PORT, dt, mode), ("float32", "float64")))


def test_f32_belief_mode_tracks_with_epoch_stamps():
    r32, r64 = pair("track")
    assert (r32["dtype"], r32["pose_dtype"], r32["time_dtype"]) == ("float32", "float32", "float64")
    assert r32["finite"]
    assert r32["xy_last"] < 0.5, r32["xy_last"]
    assert r64["dtype"] == "float64" and r64["finite"]
    assert r32["xy_rmse"] < 2.0 * r64["xy_rmse"] + 0.03, (r32["xy_rmse"], r64["xy_rmse"])


def test_f32_stays_clean_under_aggressive_motion():
    r32, r64 = pair("stress")
    assert r32["finite"]
    assert r32["n_nonfinite_rejections"] == 0
    assert r32["alpha_ok"] and r32["beta_ok"]
    assert r32["xy_rmse"] < 2.0 * r64["xy_rmse"] + 0.05, (r32["xy_rmse"], r64["xy_rmse"])


def test_f32_absorbs_loop_closure():
    r32, r64 = pair("loop")
    assert r32["finite"]
    assert r32["n_nonfinite_rejections"] == 0
    assert r32["xy_last"] < 0.3, r32["xy_last"]
    assert r32["xy_last"] < 2.0 * r64["xy_last"] + 0.05, (r32["xy_last"], r64["xy_last"])
