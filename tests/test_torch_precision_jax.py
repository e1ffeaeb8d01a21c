"""The port's f32-belief mode against the JAX package's on
generate(SyntheticConfig(n_scans=10, n_points=512)) with the map off,
each in a child process with GCSLAM_BELIEF_DTYPE=float32 (the two run at
once).

Tolerance: both packages run the same float32 formulas on the same
float32-rounded inputs and part only where a reduction sums in another
order: about one float32 ulp (6e-8 relative) of a ~0.5 m pose per step,
which ten steps of a contracting filter keep near 1e-6 m. The poses are
held at 2e-5 m / rad, ~20x that. Measured: 8.6e-7 (in f64 the same
comparison reads 5e-15)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from test_torch_precision import _PORT, _run

_JAX = r"""
import json
import jax
jax.config.update("jax_platforms", "cpu")
import gcslam_tpu
import numpy as np
from gcslam_tpu.utils.xla import BELIEF_DTYPE, jnp
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

run = generate(SyntheticConfig(n_scans=10, n_points=512))
_, out = runner.run_bag(run.batches, PipelineConfig(with_map=False))
print(json.dumps({"dtype": str(jnp.dtype(BELIEF_DTYPE)), "poses": np.asarray(out.pose, np.float64).tolist()}))
"""


def test_port_f32_matches_jax_f32():
    with ThreadPoolExecutor(2) as pool:
        got, ref = pool.map(lambda args: _run(*args), ((_PORT, "float32", "small"), (_JAX, "float32")))
    assert got["dtype"] == ref["dtype"] == "float32"
    np.testing.assert_allclose(np.array(got["poses"]), np.array(ref["poses"]), rtol=0, atol=2e-5)
