"""gcslam_torch constants and PipelineConfig against the JAX package's:
same values, same fields and defaults (minus three backend selectors that
have no meaning in the port), and validate() refusing the same configs
with the same message."""

import dataclasses

import pytest

from gcslam_tpu import constants as JC
from gcslam_tpu.models.config import PipelineConfig as JaxConfig
from gcslam_torch import constants as TC
from gcslam_torch.models.config import PipelineConfig as TorchConfig

# JAX-only backend selectors: the port runs its CUDA kernel on CUDA tensors
# and the plain loop on CPU tensors, and its top-k is always exact.
EXCLUDED = {"sinkhorn_backend", "shortlist_recall", "select_recall"}


def _public(mod):
    return {k: v for k, v in vars(mod).items() if not k.startswith("_") and not callable(v)}


def test_constants_equal():
    j, t = _public(JC), _public(TC)
    assert set(j) == set(t)
    for k in j:
        assert j[k] == t[k], k
    for r in range(4):
        assert JC.hex_disk_count_xy(r) == TC.hex_disk_count_xy(r)


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig) if f.name not in EXCLUDED]
    tf = [(f.name, f.default) for f in dataclasses.fields(TorchConfig)]
    assert jf == tf
    assert EXCLUDED <= {f.name for f in dataclasses.fields(JaxConfig)}


BAD = [
    dict(k_hyp=3),
    dict(k_sinkhorn=10),
    dict(max_imu_len=256),
    dict(eps_psd=-1.0),
    dict(merge_every=0),
    dict(ot_epsilon=0.0),
    dict(map_icp_iters=9),
    dict(k_shortlist=4),
    dict(m_tile=64, m_tile_view=128),
    dict(map_share_extraction=False),
    dict(imu_mode="bogus"),
    dict(odom_pose_mode="bogus"),
    dict(pose_modality_mode="bogus"),
    dict(surfel_min_points_per_voxel=0),
]


@pytest.mark.parametrize("overrides", BAD, ids=[next(iter(b)) for b in BAD])
def test_validate_rejects_the_same_configs(overrides):
    with pytest.raises(ValueError) as ej:
        JaxConfig(**overrides).validate()
    with pytest.raises(ValueError) as et:
        TorchConfig(**overrides).validate()
    assert str(et.value) == str(ej.value)


GOOD = [dict(), dict(with_map=False), dict(merge_every=1), dict(k_shortlist=0),
        dict(imu_mode="evidence"), dict(map_gn_shared=False)]


@pytest.mark.parametrize("overrides", GOOD, ids=[str(g) for g in GOOD])
def test_validate_accepts_the_same_configs(overrides):
    JaxConfig(**overrides).validate()
    TorchConfig(**overrides).validate()


@pytest.mark.parametrize("overrides", [
    dict(imu_mode="evidence"), dict(odom_pose_mode="relative"), dict(with_camera=True),
    dict(map_gn_shared=False), dict(k_shortlist=0), dict(ot_subtract_row_min=True),
])
def test_unported_options_are_refused(overrides):
    cfg = TorchConfig(**overrides)
    cfg.validate()
    with pytest.raises(NotImplementedError):
        cfg.check_ported()
    TorchConfig().check_ported()
