"""The synthetic generator's camera route against the JAX generator's,
unpinned: both take the native C++ corner stage by default (the JAX
package's when its library is built, which the jax_native fixture makes
sure of). The pure route of both is tests/test_torch_camera.py's
test_generate_with_camera; the switch between them tests/test_torch_native.py.

How close the native routes are: both lift the same C++ corners; the lift
and the LiDAR depth evidence sum in other orders (float32 Route B), so the
camera Gaussians agree to ~3e-9 of their scale (measured), inside the
pinned route's tolerances, which are kept here. Replayed at SMALL budgets
the poses of scans 0-2 agree to 5e-15 m; scan 2 is the first to match the
young map, and the reference's float32 point path puts its OT transport
mass 1.7 % apart (1.984 vs 1.951), which moves scan 3's pose by 1.56e-5 m,
from the same batches or each package's own (measured; the native route's
62-81 camera rows a frame, against > 200 on the pure route, leave more of
the factor to the LiDAR surfels than the pinned test's runs). So the
replays are held at 1e-4 m."""

import numpy as np
import pytest

from gcslam_tpu.frontend import synthetic as jsyn
from gcslam_tpu.models import runner as jrunner
from gcslam_tpu.models.config import PipelineConfig as JConfig
from gcslam_torch.frontend import synthetic as tsyn
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.models.scan_io import batch_from_numpy
from test_torch_bag import jax_native  # noqa: F401 (fixture)
from test_torch_camera import SMALL_CAM, rel_to_max
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

POSE_ATOL = 1e-4  # m / rad, see the module note
N_SCANS = 4


@pytest.fixture(scope="module")
def unpinned(jax_native):  # noqa: F811 (the fixture)
    """The JAX generator with its native route, and the port's default."""
    jrun = jsyn.generate(jsyn.SyntheticConfig(n_scans=N_SCANS, n_points=512, with_camera=True))
    trun = tsyn.generate(tsyn.SyntheticConfig(n_scans=N_SCANS, n_points=512, with_camera=True), device="cpu")
    return jrun, trun


def test_generate_native_route_matches_the_unpinned_jax_generator(unpinned):
    """The pinned test's tolerances (tests/test_torch_camera.py::
    test_generate_with_camera) on the native route, without replacing
    any stage of the port."""
    jrun, trun = unpinned
    np.testing.assert_array_equal(trun.gt_poses, jrun.gt_poses)
    for jb, tb in zip(jrun.batches, trun.batches):
        for f in tb._fields:
            j, t = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
            assert j.dtype == t.dtype, f
            if not f.startswith("cam_") or f in ("cam_valid", "cam_colors"):
                assert np.array_equal(j, t), f
        v = np.asarray(jb.cam_valid)
        assert v.sum() > 50  # the C++ stage keeps 62-81 corners a frame on this world (the pure route > 200)
        for f in ("cam_etas", "cam_weights"):
            assert rel_to_max(getattr(jb, f), getattr(tb, f).numpy()) < 1e-6, f
        Lj, Lt = np.asarray(jb.cam_Lambdas)[v], tb.cam_Lambdas.numpy()[v]
        row = np.abs(Lj - Lt).max((1, 2)) / np.abs(Lj).max((1, 2))
        assert np.median(row) < 1e-4


def test_run_bag_on_the_native_route_matches_jax(unpinned):
    jrun, trun = unpinned
    _, jout = jrunner.run_bag(jrun.batches, JConfig(**SMALL_CAM))
    tb = [batch_from_numpy({f: np.asarray(getattr(b, f)) for f in b._fields}, device="cpu") for b in jrun.batches]
    _, tout = runner.run_bag(tb, PipelineConfig(**SMALL_CAM), device="cpu")
    assert np.asarray(jout.tape.ot_transport_mass)[-1] > 1.0  # camera rows matched the map
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose), rtol=0, atol=POSE_ATOL)
    _, own = runner.run_bag(trun.batches, PipelineConfig(**SMALL_CAM), device="cpu")
    np.testing.assert_allclose(own.pose.numpy(), np.asarray(jout.pose), rtol=0, atol=POSE_ATOL)
