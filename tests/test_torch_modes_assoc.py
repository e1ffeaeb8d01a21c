"""The port's association options against the JAX package: k_shortlist=0
(each GN round associates against the whole view, an (N, P) cost with
P = stencil tiles x m_tile_view, and the pose factor gathers its
candidates from the view) and ot_subtract_row_min=True (the reference's
row-minimum cost normalization). Checks, world and tolerances as in
tests/test_torch_modes.py."""

import pytest

from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
from gcslam_torch.models.scan_io import batch_from_numpy
from gcslam_torch.ops import certs as CT
from test_torch_modes import one_torch_thread, OPTION_TOL, check_run_bag, check_scan_step, jax_reference  # noqa: F401 (autouse fixture)
from test_torch_slice import np_tree

OPTIONS = {
    "full_pool": dict(k_shortlist=0),
    "row_min": dict(ot_subtract_row_min=True),
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


def test_full_pool_declares_no_shortlist_pruning(run, tbatches):
    """Without a shortlist the association certificate raises no
    shortlist_pruning bit (the reference's cert rule), in both packages."""
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from test_torch_slice import SMALL

    _, outs = jax_reference(run, OPTIONS["full_pool"])
    bit = CT.TRIGGERS["shortlist_pruning"]
    assert not (outs.tape.cert_triggers.astype("int64") & bit).any()
    _, out = runner.run_bag(tbatches[:3], PipelineConfig(**SMALL, **OPTIONS["full_pool"]), device="cpu")
    assert not (out.tape.cert_triggers.numpy() & bit).any()
    _, out = runner.run_bag(tbatches[:3], PipelineConfig(**SMALL), device="cpu")
    assert (out.tape.cert_triggers.numpy() & bit).all()
