"""Numeric policy of the reference: the configuration's float64 belief
(no environment switch), float32 points, float64 times, TF32 off."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BELIEF_DTYPE = torch.float64
POINT_DTYPE = torch.float32
TIME_DTYPE = torch.float64

__all__ = ["BELIEF_DTYPE", "POINT_DTYPE", "TIME_DTYPE"]
