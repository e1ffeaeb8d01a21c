"""The port's two config-variant tools on the CPU, at small budgets:

  - tools/attribute_step writes the JAX tool's report: its top-level keys,
    and per variant its fields, with first_call_s, launch_calls_per_scan and
    device_busy_ms_per_scan in place of compile_s, gflops and gbytes (XLA's
    compile and cost analysis; the device fields, utils/cuda_profile's
    record, are None on the CPU);
  - tools/ablate_gn_shared builds the JAX tool's three modes, and each runs
    2 scans of its hard regime to a finite ATE.
"""

import dataclasses
import json

import numpy as np
import pytest

from gcslam_tpu.tools import ablate_gn_shared as jablate, attribute_step as jattr
from gcslam_torch.frontend.synthetic import generate
from gcslam_torch.tools import ablate_gn_shared, attribute_step
from gcslam_torch.utils import cuda_profile
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

# the fields the JAX tool writes (gcslam_tpu/tools/attribute_step.py: main's
# `out`, and measure()'s report per variant)
JAX_TOP = {"device", "replay", "belief_dtype", "base_budgets", "base"}
JAX_BUDGETS = {"atlas", "view", "k_shortlist", "gn_rounds"}
JAX_STEP = {"compile_s", "gflops", "gbytes", "ms_read", "ms_p50", "ms_mean"}
SMALL = dict(atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)


def test_attribute_step_report_has_the_jax_fields(tmp_path):
    assert set(attribute_step.VARIANTS) == set(jattr.VARIANTS)
    for name, over in jattr.VARIANTS.items():
        if name != "exact_shortlist":  # the JAX tool's shortlist_recall: the port's shortlist is exact
            assert attribute_step.VARIANTS[name] == over, name
    path = tmp_path / "attr.json"
    attribute_step.main(["--cpu", "--small", "--steps", "1", "--points", "1024", "--variants", "no_map,gn_1round",
                         "--precision", "f64", "--json", str(path)])
    out = json.loads(path.read_text())
    assert JAX_TOP <= set(out) and set(out["base_budgets"]) == JAX_BUDGETS
    assert out["device"] == "cpu" and out["belief_dtype"] == "float64" and out["replay"] == 0
    want = {attribute_step.IN_PLACE_OF.get(k, k) for k in JAX_STEP}
    for name in ("base", "no_map", "gn_1round"):
        assert want <= set(out[name]), (name, want - set(out[name]))
        assert {k: out[name][k] for k in cuda_profile.FIELDS} == dict.fromkeys(cuda_profile.FIELDS)
        assert out[name]["ms_p50"] > 0 and np.isfinite(out[name]["ms_mean"])
    for name in ("no_map", "gn_1round"):
        assert out[name]["delta_ms"] == pytest.approx(out["base"]["ms_p50"] - out[name]["ms_p50"], abs=2e-3)


def test_ablate_gn_shared_modes_run_to_a_finite_ate():
    configs = ablate_gn_shared.mode_configs(**SMALL)
    assert list(configs) == ["shared", "per_hyp_gn", "no_share"]
    assert [(c.map_gn_shared, c.map_share_extraction) for c in configs.values()] == [
        (True, True), (False, True), (False, False)]
    regime = ablate_gn_shared.hard_regime(2, 512)
    assert {k: getattr(regime, k) for k in ablate_gn_shared.REGIME} == ablate_gn_shared.REGIME
    run = generate(regime, device="cpu")
    for name, cfg in configs.items():
        rep = ablate_gn_shared.run_mode(cfg, run, __import__("torch").device("cpu"))
        assert rep["finite"] and np.isfinite(rep["ate_trans_rmse_m"]), name
        assert rep["sinkhorn_launches"] is None


def test_ablate_gn_shared_regime_is_the_jax_tools():
    """The JAX tool builds its world and modes inside main(): its source
    names the same regime and the same three modes (less its Sinkhorn
    backend selector, which the port does not have)."""
    src = open(jablate.__file__).read()
    for key, value in ablate_gn_shared.REGIME.items():
        assert (f'{key}="{value}"' if isinstance(value, str) else f"{key}={value}") in src, key
    for name, over in ablate_gn_shared.MODES.items():
        assert f'"{name}"' in src
        for k, v in over.items():
            assert f'"{k}": {v!r}' in src, (name, k)
    fields = {f.name for f in dataclasses.fields(ablate_gn_shared.mode_configs()["shared"])}
    assert {"map_gn_shared", "map_share_extraction"} <= fields
