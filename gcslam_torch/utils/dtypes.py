"""Numeric policy of the port (counterpart of the JAX package's utils/xla.py).

  - BELIEF_DTYPE: the 22-D belief algebra, IW states and the small dense
    factor math. float64 by default, the reference-parity precision (an
    H100 runs f64 natively). Set GCSLAM_BELIEF_DTYPE=float32 BEFORE the
    package is first imported for the JAX package's f32-belief mode, its
    production configuration: the dtype binds here, at import, as it does
    there, so a process runs one mode (eval.run --precision and
    tools/precision_compare re-execute themselves with the variable set).
  - POINT_DTYPE (float32): bulk point-cloud paths (deskew, binning,
    association cost, map storage).
  - TIME_DTYPE (float64): absolute timestamps (epoch seconds, where f32
    resolution is ~100 s), in both modes.

TF32 is switched off for both matmul and cuDNN: the JAX package forces
"highest" matmul precision (true-f32 accumulation) for the same reason —
three-digit products are fatal to association distances and, in the
f32-belief mode, to the 22 x 22 factors.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_BELIEF_DTYPE_ENV = os.environ.get("GCSLAM_BELIEF_DTYPE", "float64")
if _BELIEF_DTYPE_ENV not in ("float64", "float32"):
    raise ValueError(f"GCSLAM_BELIEF_DTYPE must be 'float64' or 'float32', got {_BELIEF_DTYPE_ENV!r}")
BELIEF_DTYPE = torch.float64 if _BELIEF_DTYPE_ENV == "float64" else torch.float32
POINT_DTYPE = torch.float32
TIME_DTYPE = torch.float64

__all__ = ["BELIEF_DTYPE", "POINT_DTYPE", "TIME_DTYPE"]
