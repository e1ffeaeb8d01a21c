"""gcslam_torch — Geometric Compositional SLAM in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The PyTorch/CUDA counterpart of the JAX package: the same per-scan pipeline
(22-D information-form belief, evidence operators, IW noise adaptation,
K_HYP hypotheses, tiled Gaussian x vMF atlas with OT association), written
as plain functions on tensors with an explicit `device`. The subpackage
layout and module names mirror the JAX package's one for one. The package imports
torch and numpy only; hand-written CUDA sources live in `csrc/` and are
built on first use (see `ops/sinkhorn.py`).

Importing this package sets the numeric policy (`utils.dtypes`): TF32 off
for matmuls and cuDNN.
"""

from gcslam_torch.utils import dtypes as _dtypes  # noqa: F401  (side effect: TF32 off)

__version__ = "0.1.0"
