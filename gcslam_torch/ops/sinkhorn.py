"""Fixed-iteration unbalanced Sinkhorn: the hand-written CUDA kernel
(csrc/sinkhorn.cu, replacing the TPU Pallas kernel
the JAX package's ops/sinkhorn_pallas.py) and its plain PyTorch version.

`sinkhorn_unbalanced` takes C (N, K) or (B, N, K), a (N,)/(B, N) and
b (K,)/(B, K). On CUDA tensors it launches the kernel — one launch for all
n_iters iterations, one thread-block cluster per problem (`cluster_layout`)
— or raises; on CPU tensors it runs `sinkhorn_unbalanced_reference`. The
kernel is compiled with nvcc on first use into csrc/build/ (a plain C
interface loaded with ctypes, ops/cuda_build.py) from the source in this
checkout.

The function is the custom operator `gcslam::sinkhorn_unbalanced`, with
the plain loop as its CPU kernel and the launch as its CUDA kernel, and a
vmap rule: under torch.func.vmap (the replay sweep's run axis,
parallel/sweep.py) every vmapped leading dim folds into the kernel's B
axis, so R runs of (N, K) problems, or of (K_HYP, N, K), are one launch of
B = R or R * K_HYP problems.

`COUNTER` counts launches where the wrapper launches the kernel. Inside a
CUDA graph capture the wrapper only records the launch; the compiled step
(models/runner.CompiledStep) moves the capture's counts to its replays, so
the count stays the number of kernels that ran.
"""

from __future__ import annotations

import ctypes

import torch

from gcslam_torch.ops.cuda_build import KernelLibrary, LaunchCounter

MAX_K = 32
MAX_CLUSTER = 8  # blocks per problem: the portable cluster size
ROWS_PER_BLOCK = 128  # rows per block the launcher aims at before the cluster is full
MAX_N = 2048  # 8 blocks x 256 threads x one register-resident row per thread
MAX_GRID_X = 2**31 - 1  # the launcher's grid is B x (blocks per cluster) blocks along x

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p]
_INT_P = ctypes.POINTER(ctypes.c_int)
_KERNEL = KernelLibrary("sinkhorn.cu", "gcslam_sinkhorn",
                        {"gcslam_sinkhorn_f32": _ARGS, "gcslam_sinkhorn_f64": _ARGS,
                         "gcslam_sinkhorn_layout": [ctypes.c_int, _INT_P, _INT_P]})
COUNTER = LaunchCounter()


def build():
    """Compile csrc/sinkhorn.cu into csrc/build/ unless that library
    exists; returns its path."""
    return _KERNEL.build()


def library_path():
    """Where build() puts the library (it exists once built)."""
    return _KERNEL.path()


def load():
    """The loaded library (csrc/sinkhorn.cu built first if needed)."""
    return _KERNEL.lib()


def build_log() -> str:
    """nvcc's output of the build made by this process ('' if none was needed)."""
    return _KERNEL.build_log


def cluster_layout(N: int):
    """(blocks per cluster, rows per block, threads per block) for an N-row
    problem, as the kernel's launcher picks them (csrc/sinkhorn.cu layout()):
    the smallest power of two of blocks, at most 8, that leaves each at most
    128 rows; then the rows spread evenly, one per thread, in whole warps."""
    cl = 1
    while cl < MAX_CLUSTER and cl * ROWS_PER_BLOCK < N:
        cl *= 2
    rows = -(-N // cl)
    return cl, rows, 32 * -(-rows // 32)


def launcher_layout(N: int):
    """(blocks per cluster, threads per block) that the built launcher picks
    for N rows (needs the built library)."""
    cl, threads = ctypes.c_int(), ctypes.c_int()
    err = _KERNEL.lib().gcslam_sinkhorn_layout(int(N), ctypes.byref(cl), ctypes.byref(threads))
    if err != 0:
        raise ValueError(f"no cluster layout for N={N}: cudaError_t {err}")
    return cl.value, threads.value


def _scalars(epsilon: float, tau_a: float, tau_b: float):
    eps = max(float(epsilon), 1e-12)
    return eps, 1.0 / (1.0 + float(tau_a) / eps), 1.0 / (1.0 + float(tau_b) / eps)


def sinkhorn_unbalanced_reference(C, a, b, epsilon, tau_a, tau_b, n_iters: int):
    """Plain PyTorch loop (same iteration and guards as the kernel)."""
    eps, ua, vb = _scalars(epsilon, tau_a, tau_b)
    K_mat = torch.exp(-C / eps)
    u = torch.ones_like(a)
    v = torch.ones_like(b)
    for _ in range(n_iters):
        u = (a / ((K_mat @ v.unsqueeze(-1)).squeeze(-1) + 1e-12)) ** ua
        v = (b / ((K_mat.transpose(-1, -2) @ u.unsqueeze(-1)).squeeze(-1) + 1e-12)) ** vb
    return u[..., :, None] * K_mat * v[..., None, :]


def _check(C, a, b):
    if C.dim() not in (2, 3):
        raise ValueError(f"C must be (N, K) or (B, N, K), got {tuple(C.shape)}")
    N, K = C.shape[-2:]
    lead = C.shape[:-2]
    if a.shape != lead + (N,) or b.shape != lead + (K,):
        raise ValueError(f"shape mismatch: C {tuple(C.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if C.dtype not in (torch.float32, torch.float64) or a.dtype != C.dtype or b.dtype != C.dtype:
        raise TypeError(f"C, a, b must share float32 or float64, got {C.dtype}, {a.dtype}, {b.dtype}")
    if not (1 <= K <= MAX_K and 1 <= N <= MAX_N):
        raise ValueError(f"kernel supports 1 <= N <= {MAX_N}, 1 <= K <= {MAX_K}; got N={N}, K={K}")
    B = C.shape[0] if C.dim() == 3 else 1
    if B * cluster_layout(N)[0] > MAX_GRID_X:
        raise ValueError(f"B={B} problems of N={N} rows exceed the launch grid ({MAX_GRID_X} blocks)")
    if not (C.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("C, a, b must be contiguous")
    if not (C.is_cuda and a.device == C.device and b.device == C.device):
        raise ValueError("C, a, b must lie on one CUDA device")


@torch.library.custom_op("gcslam::sinkhorn_unbalanced", mutates_args=(), device_types="cpu")
def _sinkhorn_op(C: torch.Tensor, a: torch.Tensor, b: torch.Tensor, epsilon: float, tau_a: float,
                 tau_b: float, n_iters: int) -> torch.Tensor:
    return sinkhorn_unbalanced_reference(C, a, b, epsilon, tau_a, tau_b, n_iters)


@_sinkhorn_op.register_kernel("cuda")
def _sinkhorn_launch(C, a, b, epsilon, tau_a, tau_b, n_iters):
    _check(C, a, b)
    lib = _KERNEL.lib()
    eps, ua, vb = _scalars(epsilon, tau_a, tau_b)
    N, K = C.shape[-2:]
    B = C.shape[0] if C.dim() == 3 else 1
    out = torch.empty_like(C)
    fn = lib.gcslam_sinkhorn_f64 if C.dtype == torch.float64 else lib.gcslam_sinkhorn_f32
    stream = torch.cuda.current_stream(C.device).cuda_stream
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 B, N, K, eps, ua, vb, int(n_iters), stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed: cudaError_t {err}")
    COUNTER.count((B, N, K), C.dtype)
    return out


@_sinkhorn_op.register_vmap
def _sinkhorn_vmap(info, in_dims, C, a, b, epsilon, tau_a, tau_b, n_iters):
    """Fold the vmapped dim and every leading problem dim into one B axis:
    one call (on CUDA one launch) for all problems of all runs."""
    R = info.batch_size

    def front(x, d):
        return x.expand((R,) + x.shape) if d is None else x.movedim(d, 0)

    C, a, b = front(C, in_dims[0]), front(a, in_dims[1]), front(b, in_dims[2])
    N, K = C.shape[-2:]
    lead = torch.broadcast_shapes(C.shape[:-2], a.shape[:-1], b.shape[:-1])
    out = _sinkhorn_op(C.expand(lead + (N, K)).reshape(-1, N, K).contiguous(),
                       a.expand(lead + (N,)).reshape(-1, N).contiguous(),
                       b.expand(lead + (K,)).reshape(-1, K).contiguous(),
                       epsilon, tau_a, tau_b, n_iters)
    return out.reshape(lead + (N, K)), 0


def sinkhorn_unbalanced(C, a, b, epsilon, tau_a, tau_b, n_iters: int):
    """pi = diag(u) exp(-C/eps) diag(v) after n_iters unbalanced Sinkhorn
    iterations; the kernel on CUDA tensors, the plain loop on CPU tensors."""
    return _sinkhorn_op(C, a, b, float(epsilon), float(tau_a), float(tau_b), int(n_iters))
