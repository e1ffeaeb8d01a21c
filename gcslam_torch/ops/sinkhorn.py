"""Fixed-iteration unbalanced Sinkhorn: the hand-written CUDA kernel
(csrc/sinkhorn.cu, replacing the TPU Pallas kernel
the JAX package's ops/sinkhorn_pallas.py) and its plain PyTorch version.

`sinkhorn_unbalanced` takes C (N, K) or (B, N, K), a (N,)/(B, N) and
b (K,)/(B, K). On CUDA tensors it launches the kernel — one launch for all
n_iters iterations, one thread block per problem — or raises; on CPU
tensors it runs `sinkhorn_unbalanced_reference`. The kernel is compiled
with nvcc on first use into csrc/build/ (a plain C interface loaded with
ctypes, ops/cuda_build.py) from the source in this checkout.
"""

from __future__ import annotations

import ctypes

import torch

from gcslam_torch.ops.cuda_build import KernelLibrary, LaunchCounter

MAX_K = 32
MAX_N = 2048  # 256 threads x 8 register-resident rows per thread

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p]
_KERNEL = KernelLibrary("sinkhorn.cu", "gcslam_sinkhorn",
                        {"gcslam_sinkhorn_f32": _ARGS, "gcslam_sinkhorn_f64": _ARGS})
COUNTER = LaunchCounter()


def build():
    """Compile csrc/sinkhorn.cu into csrc/build/ unless that library
    exists; returns its path."""
    return _KERNEL.build()


def build_log() -> str:
    """nvcc's output of the build made by this process ('' if none was needed)."""
    return _KERNEL.build_log


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
    if not (C.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("C, a, b must be contiguous")
    if not (C.is_cuda and a.device == C.device and b.device == C.device):
        raise ValueError("C, a, b must lie on one CUDA device")


def sinkhorn_unbalanced(C, a, b, epsilon, tau_a, tau_b, n_iters: int):
    """pi = diag(u) exp(-C/eps) diag(v) after n_iters unbalanced Sinkhorn
    iterations; the kernel on CUDA tensors, the plain loop on CPU tensors."""
    if C.device.type == "cpu":
        return sinkhorn_unbalanced_reference(C, a, b, epsilon, tau_a, tau_b, n_iters)
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
    COUNTER.launches += 1
    return out
