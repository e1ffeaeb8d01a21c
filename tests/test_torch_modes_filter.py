"""The port's filter options against the JAX package: imu_mode='evidence'
(diffusion prediction + gyro and preintegration factors, the yaw-rate and
kinematic factors on) and odom_pose_mode='relative' (odometry target
pose0 o odom_rel_pose, its covariance inflated by the head's marginals).
Checks, world and tolerances as in tests/test_torch_modes.py."""

import pytest

from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_torch.models.scan_io import batch_from_numpy
from test_torch_modes import one_torch_thread, OPTION_TOL, check_run_bag, check_scan_step  # noqa: F401 (autouse fixture)
from test_torch_slice import np_tree

OPTIONS = {
    "imu_evidence": dict(imu_mode="evidence"),
    "odom_relative": dict(odom_pose_mode="relative"),
}


@pytest.fixture(scope="module")
def run():
    return jgenerate(JSynth(n_scans=10, n_points=512))


@pytest.fixture(scope="module")
def tbatches(run):
    return [batch_from_numpy(np_tree(b), device="cpu") for b in run.batches]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_scan_step_from_a_shared_state(run, tbatches, option):
    check_scan_step(run, tbatches, OPTIONS[option], OPTION_TOL.get(option))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_run_bag_from_a_shared_state(run, tbatches, option):
    check_run_bag(run, tbatches, OPTIONS[option], OPTION_TOL.get(option))
