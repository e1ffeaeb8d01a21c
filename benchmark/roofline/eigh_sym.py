"""The symmetric Jacobi eigensolver kernel (csrc/eigh.cu, eigh_sym_kernel):
B matrices of n x n. Bytes: the matrices read once, the eigenvalues and
eigenvectors written once. Operations: 15 cyclic sweeps (the kernel's
compiled count) of n' - 1 rounds of n' / 2 rotations (n' = n rounded up to
even), each rotation ~20 operations and its row and column passes 6 per
entry of rows p, q and columns p, q of A and of V (18 n), and the
symmetrization and scaling (3 n^2)."""

from benchmark.roofline import ITEMSIZE, bound_seconds

COUNTER = ("gcslam_torch.ops.eigh", "EIGH_SYM_COUNTER")
KERNEL = "eigh_sym_kernel<"
SWEEPS = 15


def flops(n: int) -> int:
    players = n + (n & 1)
    return SWEEPS * (players - 1) * (players // 2) * (20 + 18 * n) + 3 * n * n


def seconds(dtype: str, shape, config: dict) -> float:
    B, n, _ = shape
    n_bytes = ITEMSIZE[dtype] * B * (2 * n * n + n)
    return bound_seconds(n_bytes, B * flops(n), dtype)
