"""Roofline bounds of the program's kernels, frozen with the benchmark: the
peaks of one NVIDIA H100 SXM (data sheet, dense, non-tensor-core rates) and,
in one module per kernel, the bytes and operations a call needs.

A kernel module names the program's launch counter of the kernel (COUNTER:
module, attribute; its by_instance counts launches by (dtype, shape)), a
substring of the kernel's name in the device trace (KERNEL), and
seconds(dtype, shape, config): the least time the card could take for one
call, the larger of the bytes over the memory bandwidth and the operations
over the dtype's peak. Each input byte is counted once and each output byte
once."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}


def bound_seconds(n_bytes: float, n_ops: float, dtype: str) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype])


def share(ctx, kernel: str):
    """The kernel's share of its roofline in the traced stretch, in %: the
    summed bounds of the calls its launch counter saw over the kernel's
    device time in the trace. None where the stretch ran none."""
    stretch = ctx["stretch"]
    if stretch is None or kernel not in ctx["counters"]:
        return None
    mod = ctx["rooflines"][kernel]
    launches, by_instance = ctx["counters"][kernel]
    records, seconds = stretch.kernel_time(mod.KERNEL)
    if not launches or not records or seconds <= 0:
        return None
    config = ctx["run"].cell.config
    bound = sum(n * mod.seconds(dtype, shape, config) for (dtype, shape), n in by_instance.items())
    return 100.0 * bound / seconds
