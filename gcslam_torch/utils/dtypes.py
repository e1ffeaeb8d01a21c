"""Numeric policy of the port (counterpart of the JAX package's utils/xla.py).

  - BELIEF_DTYPE (float64): the 22-D belief algebra, IW states and the small
    dense factor math. An H100 runs f64 natively, so the reference-parity
    precision is the default and the only mode of the port.
  - POINT_DTYPE (float32): bulk point-cloud paths (deskew, binning,
    association cost, map storage).
  - TIME_DTYPE (float64): absolute timestamps (epoch seconds, where f32
    resolution is ~100 s).

TF32 is switched off for both matmul and cuDNN: the JAX package forces
"highest" matmul precision (true-f32 accumulation) for the same reason —
three-digit products are fatal to association distances.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BELIEF_DTYPE = torch.float64
POINT_DTYPE = torch.float32
TIME_DTYPE = torch.float64

__all__ = ["BELIEF_DTYPE", "POINT_DTYPE", "TIME_DTYPE"]
