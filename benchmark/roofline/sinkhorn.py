"""The unbalanced Sinkhorn kernel (csrc/sinkhorn.cu): B problems of an
(N, K) cost. Bytes: the cost, a and b read once, the plan written once.
Operations: exp(-C / eps) and the final diag(u) K diag(v) (3 N K), and per
iteration two matrix-vector products (4 N K) and the N + K divide-and-power
updates; the iterations are the configuration's k_sinkhorn."""

from benchmark.roofline import ITEMSIZE, bound_seconds

COUNTER = ("gcslam_torch.ops.sinkhorn", "COUNTER")
KERNEL = "sinkhorn_kernel<"


def seconds(dtype: str, shape, config: dict) -> float:
    B, N, K = shape
    iters = config["pipeline"]["k_sinkhorn"]
    n_bytes = ITEMSIZE[dtype] * B * (2 * N * K + N + K)
    n_ops = B * (3 * N * K + iters * (4 * N * K + N + K))
    return bound_seconds(n_bytes, n_ops, dtype)
