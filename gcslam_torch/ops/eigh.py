"""Batched symmetric eigendecompositions of the scan step: the hand-written
CUDA kernels of csrc/eigh.cu and their plain PyTorch versions.

  - eigh3(M): (..., 3, 3) by 6 sweeps of cyclic Jacobi, the JAX package's
    ops/linalg.eigh_3x3. Its plain version `eigh3_reference` is the port's
    chain of small ops (a rotation is ~38 launches on the card); the CPU
    path runs it. The kernel rotates only rows and columns p, q (the same
    bits but for the sign of a zero).
  - psd3(M, eps_psd): (..., 3, 3) -> (M_psd, certificate (..., 6)), the
    whole of linalg.domain_projection_psd for n = 3 (symmetrize, eigh3,
    floor, reconstruct, the six PsdCert fields) in one launch of the same
    kernel. Its plain version `psd3_reference` is the composition the
    projection made before (`psd_parts`, the torch epilogue, through
    eigh3_reference), which the CPU path runs bit for bit.
  - eigh_sym(M): (..., n, n) for n <= MAX_N by EIGH_SYM_SWEEPS sweeps of
    round-robin parallel-ordered Jacobi, with no info check and no host
    sync (torch.linalg.eigh's cuSOLVER call checks its info on the host).
    Its plain version `eigh_sym_reference` is the same fixed-sweep Jacobi
    in plain torch, one vectorized step per round.
  - eigh(M) / eigvalsh(M): what the step calls. 3 x 3 goes to eigh3. Other
    sizes go to eigh_sym on CUDA tensors; on CPU tensors to
    torch.linalg.eigh / eigvalsh, LAPACK, the routine the JAX package
    reaches through jnp.linalg.eigh on the CPU (its ops/linalg.py:45 and
    models/scan_step.py:593). So the CPU numbers of the step are the ones
    the JAX package's tests compare with, and the CPU test suite does not
    run the plain Jacobi's 231 rotations x EIGH_SYM_SWEEPS per 22 x 22
    call.

eigh3, psd3 and eigh_sym are the custom operators `gcslam::eigh3`,
`gcslam::psd3` and `gcslam::eigh_sym`: the plain version their CPU kernel,
the launch their CUDA kernel (outputs from torch.empty, no host sync, so a
CUDA graph captures it), a vmap rule that folds every vmapped dim into the
one launch (parallel/sweep vmaps scan_step) and a LaunchCounter each
(EIGH3_COUNTER, PSD3_COUNTER, EIGH_SYM_COUNTER). `eigh3_chain` and
`sym_chain` time the kernels' rotation chains alone and `empty_launch` a
launch that does nothing (chip_smoke.py phase 2); they are on no path.
The kernels are compiled with nvcc on first use into csrc/build/
(ops/cuda_build.py), with --fmad=false so that each performs its plain
version's IEEE operations: eigh_sym in the same order, eigh3 and psd3 up
to the order of the plain chain's 3 x 3 products and of the projection's
norms (cuBLAS and torch reductions on the card). Eigenvalues are ascending; ties keep index order
(the rank ordering of the JAX eigh_3x3; a NaN matrix gives NaN).
Eigenvectors are not sign-normalized.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from gcslam_torch.ops.cuda_build import KernelLibrary, LaunchCounter

MAX_N = 32  # eigh_sym: the kernel's largest n
MAX_BATCH = 2**31 - 1  # matrices a launch (eigh_sym: one block each along the grid's x)
# eigh_sym's sweeps, from a convergence check of the plain version at
# 22 x 22 (tests/test_torch_eigh.py::test_sweeps_converge): on random
# rotations of spectra with condition numbers up to 1e12, the slowest
# case is two tight clusters of 11 eigenvalues each; the slowest such
# matrix found keeps a reconstruction error above 1e-13 of |M| after 14
# sweeps and is at the rounding floor after 15. Graded, diagonally
# dominant matrices (the step's information matrices) reach the floor by
# sweep 6. The kernel compiles the count in as kSymSweeps (csrc/eigh.cu).
EIGH_SYM_SWEEPS = 15
EIGH3_SWEEPS = 6

_ARGS3 = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
_ARGS_SYM = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_ARGS_CHAIN = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
_ARGS_CHAIN3 = [ctypes.c_void_p] * 3
_ARGS_PSD3 = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
# --fmad=false: no multiply-add contraction, the plain versions' IEEE operations
_KERNEL = KernelLibrary("eigh.cu", "gcslam_eigh",
                        {"gcslam_eigh3_f32": _ARGS3, "gcslam_eigh3_f64": _ARGS3,
                         "gcslam_eigh_sym_f32": _ARGS_SYM, "gcslam_eigh_sym_f64": _ARGS_SYM,
                         "gcslam_eigh_sym_chain_f32": _ARGS_CHAIN, "gcslam_eigh_sym_chain_f64": _ARGS_CHAIN,
                         "gcslam_psd3_f32": _ARGS_PSD3, "gcslam_psd3_f64": _ARGS_PSD3,
                         "gcslam_eigh3_chain_f32": _ARGS_CHAIN3, "gcslam_eigh3_chain_f64": _ARGS_CHAIN3,
                         "gcslam_empty": [ctypes.c_void_p]},
                        extra_flags=["--fmad=false"])
EIGH3_COUNTER = LaunchCounter()
PSD3_COUNTER = LaunchCounter()
EIGH_SYM_COUNTER = LaunchCounter()


def build():
    """Compile csrc/eigh.cu into csrc/build/ unless that library exists;
    returns its path."""
    return _KERNEL.build()


def library_path():
    return _KERNEL.path()


def load():
    """The loaded library (csrc/eigh.cu built first if needed)."""
    return _KERNEL.lib()


def build_log() -> str:
    """nvcc's output of the build made by this process ('' if none was needed)."""
    return _KERNEL.build_log


# --- plain versions ---------------------------------------------------------

def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def _rotation(app, aqq, apq):
    """(c, s, small) of the Jacobi rotation zeroing A[p, q] in the algebraic
    form of the JAX eigh_3x3: J[p, p] = J[q, q] = c, J[p, q] = s,
    J[q, p] = -s; `small` (|apq| negligible) leaves J the identity."""
    d = aqq - app
    r = torch.sqrt(d * d + 4.0 * apq * apq)
    small = apq.abs() <= 1e-24 * (app.abs() + aqq.abs() + 1e-30)
    sgn_d = torch.where(d >= 0.0, 1.0, -1.0)
    t = torch.where(small, 0.0, sgn_d * 2.0 * apq / (d.abs() + r + 1e-300))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c, small


def _jacobi_rot_3x3(A: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One batched rotation zeroing A[..., p, q]: A <- sym(J^T A J), V <- V J."""
    c, s, _ = _rotation(A[..., p, p], A[..., q, q], A[..., p, q])
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    entry = {(p, p): c, (q, q): c, (p, q): s, (q, p): -s}
    J = torch.stack([entry.get((i, j), one if i == j else zero) for i in range(3) for j in range(3)],
                    dim=-1).unflatten(-1, (3, 3))
    return _sym(J.transpose(-1, -2) @ A @ J), V @ J


def _scaled(M: torch.Tensor):
    """(sym(M) / max|sym(M)|, the scale): Jacobi is scale-invariant, and O(1)
    entries keep the rotation algebra inside the f32 exponent range."""
    A = _sym(M)
    scale = A.abs().amax(dim=(-2, -1), keepdim=True)
    scale_safe = torch.where(scale > 0.0, scale, 1.0)
    return A / scale_safe, scale_safe


def _ascending(lam: torch.Tensor, V: torch.Tensor):
    """Eigenvalues ascending, ties by index (a stable argsort), by counting
    ranks; a NaN eigenvalue gets rank 0 and duplicates an index, as in the
    JAX eigh_3x3."""
    n = lam.shape[-1]
    idx = torch.arange(n, device=lam.device)
    less = (lam[..., None, :] < lam[..., :, None]) | (
        (lam[..., None, :] == lam[..., :, None]) & (idx[None, :] < idx[:, None])
    )
    rank = less.sum(-1)
    order = torch.argmax((rank[..., None, :] == idx[:, None]).to(torch.int8), dim=-1)
    return torch.gather(lam, -1, order), torch.gather(V, -1, order[..., None, :].expand(V.shape))


def eigh3_reference(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 3 x 3 eigendecomposition by cyclic Jacobi over (0, 1),
    (0, 2), (1, 2), as a chain of batched torch ops."""
    A, scale_safe = _scaled(M)
    V = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)
    for _ in range(EIGH3_SWEEPS):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rot_3x3(A, V, p, q)
    return _ascending(torch.diagonal(A, dim1=-2, dim2=-1) * scale_safe[..., 0], V)


def psd_parts(M: torch.Tensor, eps_psd: float, eig=eigh3_reference):
    """linalg.domain_projection_psd in plain torch, with `eig` the
    eigendecomposition of sym(M): M_sym, sym_delta, eig(M_sym), the
    eigenvalue floor, M_psd = (V * vals) V^T, and the certificate; returns
    (M_psd, [projection_delta, sym_delta, eig_min, eig_max, cond,
    near_null_count]) (linalg.PsdCert's order)."""
    M_sym = _sym(M)
    sym_delta = torch.linalg.matrix_norm(M_sym - M, ord="fro")
    eigvals, eigvecs = eig(M_sym)
    vals = torch.clamp(eigvals, min=eps_psd)
    M_psd = (eigvecs * vals[..., None, :]) @ eigvecs.transpose(-1, -2)
    projection_delta = torch.linalg.matrix_norm(M_psd - M_sym, ord="fro")
    eig_min = vals.amin(-1)
    eig_max = vals.amax(-1)
    near_null = torch.sum(vals < 10.0 * eps_psd, dim=-1).to(M.dtype)
    return M_psd, [projection_delta, sym_delta, eig_min, eig_max, eig_max / eig_min, near_null]


def psd3_reference(M: torch.Tensor, eps_psd: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of psd3: psd_parts through eigh3_reference, the
    certificate fields stacked on a last axis of 6."""
    M_psd, fields = psd_parts(M, eps_psd)
    return M_psd, torch.stack(fields, -1)


@lru_cache(maxsize=None)
def round_robin(n: int) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """The pairs (P, Q) of every round of one sweep, P < Q: the circle
    method over n rounded up to even (player 0 fixed, the others turning),
    without the pair of the odd-n dummy player n (csrc/eigh.cu circle())."""
    m = n + (n & 1)

    def player(pos, r):
        return 0 if pos == 0 else 1 + (pos - 1 + r) % (m - 1)

    rounds = []
    for r in range(m - 1):
        pairs = [sorted((player(k, r), player(m - 1 - k, r))) for k in range(m // 2)]
        pairs = [(p, q) for p, q in pairs if q < n]
        rounds.append(tuple(np.array(col, dtype=np.int64).reshape(-1) for col in zip(*pairs)) if pairs
                      else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
    return tuple(rounds)


@lru_cache(maxsize=None)
def _round_tensors(n: int, device: torch.device):
    return tuple((torch.as_tensor(P, device=device), torch.as_tensor(Q, device=device))
                 for P, Q in round_robin(n))


def eigh_sym_reference(M: torch.Tensor, n_sweeps: int = EIGH_SYM_SWEEPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric n x n eigendecomposition by n_sweeps sweeps of parallel-
    ordered Jacobi: in each round of `round_robin(n)` every pair (p, q)
    takes eigh3's rotation from the current A, then rows p, q of A, then
    columns p, q of A and of V are rotated, and a rotated pair's A[p, q],
    A[q, p] are set to 0."""
    n = M.shape[-1]
    A, scale_safe = _scaled(M)
    V = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    rows = torch.arange(n, device=M.device)[:, None]
    for _ in range(n_sweeps):
        for P, Q in _round_tensors(n, M.device):
            c, s, small = _rotation(A[..., P, P], A[..., Q, Q], A[..., P, Q])
            cr, sr = c[..., :, None], s[..., :, None]
            Ap, Aq = A[..., P, :], A[..., Q, :]
            A = A.index_copy(-2, P, cr * Ap - sr * Aq).index_copy(-2, Q, sr * Ap + cr * Aq)
            cc, sc = c[..., None, :], s[..., None, :]
            rot = ~small[..., None, :]
            Ap, Aq = A[..., :, P], A[..., :, Q]
            new_p = torch.where((rows == Q) & rot, 0.0, cc * Ap - sc * Aq)
            new_q = torch.where((rows == P) & rot, 0.0, sc * Ap + cc * Aq)
            A = A.index_copy(-1, P, new_p).index_copy(-1, Q, new_q)
            Vp, Vq = V[..., :, P], V[..., :, Q]
            V = V.index_copy(-1, P, cc * Vp - sc * Vq).index_copy(-1, Q, sc * Vp + cc * Vq)
    return _ascending(torch.diagonal(A, dim1=-2, dim2=-1) * scale_safe[..., 0], V)


def _next_entry(A, pi, qi, si, ci, s_i, pj, qj, sj, cj, s_j):
    """Entry of the next round's A for a row on side si (0: p, 1: q) of pair
    (pi, qi) and a column on side sj of pair (pj, qj), from this round's A
    and (c, s): the row rotation, then the column rotation, as
    csrc/eigh.cu's block_entry computes it."""
    ui, vi = (s_i, ci) if si else (ci, -s_i)
    x = ui * A[pi, pj] + vi * A[qi, pj]
    y = ui * A[pi, qj] + vi * A[qi, qj]
    uj, vj = (s_j, cj) if sj else (cj, -s_j)
    return uj * x + vj * y


def sym_chain_reference(block: torch.Tensor, n_rounds: int) -> torch.Tensor:
    """The plain version of csrc/eigh.cu's eigh_sym_chain_kernel: n_rounds
    dependent rounds of one rotation lane's work (the three entries of the
    pair (0, 3) from the 4 x 4 `block` and the last (c, s), then the
    rotation); returns the last (c, s)."""
    c = torch.ones((), dtype=block.dtype, device=block.device)
    s = torch.zeros((), dtype=block.dtype, device=block.device)
    for _ in range(n_rounds):
        app = _next_entry(block, 0, 1, 0, c, s, 0, 1, 0, c, s)
        aqq = _next_entry(block, 2, 3, 1, c, s, 2, 3, 1, c, s)
        apq = _next_entry(block, 0, 1, 0, c, s, 2, 3, 1, c, s)
        c, s, _ = _rotation(app, aqq, apq)
    return torch.stack([c, s])


def _rotate_a(app, aqq, apq, apr, aqr, c, s):
    """The sparse rotation of a symmetric 3 x 3 A zeroing A[p, q] (r the
    third index), on (A[p, p], A[q, q], A[p, q], A[p, r], A[q, r]): the
    non-zero terms of J^T A and of (J^T A) J in their order, then
    0.5 (Y + Y^T) where Y is not symmetric (csrc/eigh.cu rotate_a)."""
    xpp, xpq = c * app - s * apq, c * apq - s * aqq
    xqp, xqq = s * app + c * apq, s * apq + c * aqq
    return (c * xpp - s * xpq, s * xqp + c * xqq, 0.5 * ((s * xpp + c * xpq) + (c * xqp - s * xqq)),
            c * apr - s * aqr, s * apr + c * aqr)


def eigh3_chain_reference(M: torch.Tensor) -> torch.Tensor:
    """The plain version of csrc/eigh.cu's eigh3_chain_kernel: eigh3's
    symmetrization and scaling, then its 18 rotations on A alone (the
    sparse update, no V, no ordering); returns the scaled diagonal of the
    last A (..., 3)."""
    A, _ = _scaled(M)
    a00, a11, a22, a01, a02, a12 = (A[..., i, j] for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)))
    for _ in range(EIGH3_SWEEPS):
        c, s, _ = _rotation(a00, a11, a01)
        a00, a11, a01, a02, a12 = _rotate_a(a00, a11, a01, a02, a12, c, s)
        c, s, _ = _rotation(a00, a22, a02)
        a00, a22, a02, a01, a12 = _rotate_a(a00, a22, a02, a01, a12, c, s)
        c, s, _ = _rotation(a11, a22, a12)
        a11, a22, a12, a01, a02 = _rotate_a(a11, a22, a12, a01, a02, c, s)
    return torch.stack([a00, a11, a22], -1)


def eigh3_chain(M: torch.Tensor) -> torch.Tensor:
    """eigh3's latency floor: its 18 rotations' dependent chain on one
    matrix in one thread (csrc/eigh.cu eigh3_chain_kernel) on a CUDA
    (3, 3) M, its plain version on a CPU one. A measurement probe
    (chip_smoke.py phase 2), on no path of the step."""
    if M.shape != (3, 3) or M.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected a float32 or float64 (3, 3) matrix, got {M.dtype} {tuple(M.shape)}")
    if not M.is_cuda:
        return eigh3_chain_reference(M)
    lib = _KERNEL.lib()
    fn = lib.gcslam_eigh3_chain_f64 if M.dtype == torch.float64 else lib.gcslam_eigh3_chain_f32
    m = M.contiguous()
    out = torch.empty(3, dtype=M.dtype, device=M.device)
    with torch.cuda.device(M.device):
        err = fn(m.data_ptr(), out.data_ptr(), torch.cuda.current_stream(M.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"eigh3_chain launch failed: cudaError_t {err}")
    return out


def empty_launch(device: torch.device) -> None:
    """One launch of csrc/eigh.cu's empty_kernel (a thread that does
    nothing) on `device`'s current stream: the fixed cost of a launch of
    this library (chip_smoke.py phase 2). A measurement probe."""
    with torch.cuda.device(device):
        err = _KERNEL.lib().gcslam_empty(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError_t {err}")


def sym_rounds(n: int) -> int:
    """eigh_sym's Jacobi rounds a call at n x n: EIGH_SYM_SWEEPS sweeps of
    n' - 1 rounds (n' = n rounded up to even)."""
    return EIGH_SYM_SWEEPS * (n + (n & 1) - 1)


def sym_chain(block: torch.Tensor, n_rounds: int) -> torch.Tensor:
    """eigh_sym's latency floor: n_rounds rounds of the rotation lane's
    dependent chain in one thread (csrc/eigh.cu eigh_sym_chain_kernel) on a
    CUDA (4, 4) block, its plain version on a CPU one. A measurement probe
    (chip_smoke.py phase 2), on no path of the step."""
    if block.shape != (4, 4) or block.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected a float32 or float64 (4, 4) block, got {block.dtype} {tuple(block.shape)}")
    if not block.is_cuda:
        return sym_chain_reference(block, n_rounds)
    lib = _KERNEL.lib()
    fn = lib.gcslam_eigh_sym_chain_f64 if block.dtype == torch.float64 else lib.gcslam_eigh_sym_chain_f32
    blk = block.contiguous()
    out = torch.empty(2, dtype=block.dtype, device=block.device)
    with torch.cuda.device(block.device):
        err = fn(blk.data_ptr(), out.data_ptr(), n_rounds, torch.cuda.current_stream(block.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"eigh_sym_chain launch failed: cudaError_t {err}")
    return out


# --- the kernels --------------------------------------------------------------

def _check(M: torch.Tensor, n_min: int, n_max: int) -> None:
    if M.dim() < 2 or M.shape[-1] != M.shape[-2] or not n_min <= M.shape[-1] <= n_max:
        raise ValueError(f"expected (..., n, n) with {n_min} <= n <= {n_max}, got {tuple(M.shape)}")
    if M.numel() // (M.shape[-1] ** 2) > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} matrices a launch, got {M.numel() // (M.shape[-1] ** 2)}")
    if M.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {M.dtype}")
    if not M.is_cuda:
        raise ValueError("the kernel takes a CUDA tensor")


def _launch(fn, counter: LaunchCounter, M: torch.Tensor, *args, tails=None):
    """The two outputs of one launch on the (..., n, n) batch M: by default
    (eigenvalues (..., n), eigenvectors (..., n, n)), else of trailing
    shapes `tails`. The outputs come from torch.empty and nothing waits on
    the host, so a CUDA graph can capture the launch."""
    n = M.shape[-1]
    flat = M.reshape(-1, n, n).contiguous()
    tails = ((n,), (n, n)) if tails is None else tails
    out = [torch.empty(flat.shape[:1] + t, dtype=M.dtype, device=M.device) for t in tails]
    if flat.shape[0]:
        stream = torch.cuda.current_stream(M.device).cuda_stream
        with torch.cuda.device(M.device):
            err = fn(flat.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), flat.shape[0], *args, stream)
        if err != 0:
            raise RuntimeError(f"eigh kernel launch failed: cudaError_t {err}")
        counter.count(tuple(flat.shape), M.dtype)
    return tuple(o.reshape(M.shape[:-2] + t) for o, t in zip(out, tails))


@torch.library.custom_op("gcslam::eigh3", mutates_args=(), device_types="cpu")
def _eigh3_op(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return eigh3_reference(M)


@_eigh3_op.register_kernel("cuda")
def _eigh3_launch(M):
    _check(M, 3, 3)
    lib = _KERNEL.lib()
    fn = lib.gcslam_eigh3_f64 if M.dtype == torch.float64 else lib.gcslam_eigh3_f32
    return _launch(fn, EIGH3_COUNTER, M)


@torch.library.custom_op("gcslam::psd3", mutates_args=(), device_types="cpu")
def _psd3_op(M: torch.Tensor, eps_psd: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return psd3_reference(M, eps_psd)


@_psd3_op.register_kernel("cuda")
def _psd3_launch(M, eps_psd):
    _check(M, 3, 3)
    lib = _KERNEL.lib()
    fn = lib.gcslam_psd3_f64 if M.dtype == torch.float64 else lib.gcslam_psd3_f32
    return _launch(fn, PSD3_COUNTER, M, eps_psd, 10.0 * eps_psd, tails=((3, 3), (6,)))


@torch.library.custom_op("gcslam::eigh_sym", mutates_args=(), device_types="cpu")
def _eigh_sym_op(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return eigh_sym_reference(M)


@_eigh_sym_op.register_kernel("cuda")
def _eigh_sym_launch(M):
    _check(M, 1, MAX_N)
    lib = _KERNEL.lib()
    fn = lib.gcslam_eigh_sym_f64 if M.dtype == torch.float64 else lib.gcslam_eigh_sym_f32
    return _launch(fn, EIGH_SYM_COUNTER, M, M.shape[-1])


@_eigh3_op.register_vmap
def _eigh3_vmap(info, in_dims, M):
    """The vmapped dim is one more leading batch dim: one call (on CUDA one
    launch) for every matrix of every run."""
    if in_dims[0] is None:
        return _eigh3_op(M), (None, None)
    return _eigh3_op(M.movedim(in_dims[0], 0)), (0, 0)


@_psd3_op.register_vmap
def _psd3_vmap(info, in_dims, M, eps_psd):
    if in_dims[0] is None:
        return _psd3_op(M, eps_psd), (None, None)
    return _psd3_op(M.movedim(in_dims[0], 0), eps_psd), (0, 0)


@_eigh_sym_op.register_vmap
def _eigh_sym_vmap(info, in_dims, M):
    if in_dims[0] is None:
        return _eigh_sym_op(M), (None, None)
    return _eigh_sym_op(M.movedim(in_dims[0], 0)), (0, 0)


def eigh3(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), eigenvectors as columns (..., 3, 3))
    of the symmetric part of M (..., 3, 3): the kernel on CUDA tensors, the
    plain chain on CPU tensors."""
    return _eigh3_op(M)


def psd3(M: torch.Tensor, eps_psd: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """linalg.domain_projection_psd of M (..., 3, 3): (M_psd (..., 3, 3),
    the certificate (..., 6) in linalg.PsdCert's field order). On CUDA
    tensors one launch of the eigh3 kernel with the projection fused in;
    on CPU tensors its plain version (psd_parts through eigh3_reference)."""
    return _psd3_op(M, eps_psd)


def eigh_sym(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., n), eigenvectors as columns (..., n, n))
    of the symmetric part of M (..., n, n), n <= MAX_N: the kernel on CUDA
    tensors, the plain fixed-sweep Jacobi on CPU tensors."""
    return _eigh_sym_op(M)


def eigh(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's symmetric eigendecomposition: eigh3 for 3 x 3; other sizes
    eigh_sym on CUDA and torch.linalg.eigh (LAPACK) on the CPU."""
    if M.shape[-1] == 3:
        return eigh3(M)
    if M.is_cuda:
        return eigh_sym(M)
    return torch.linalg.eigh(M)


def eigvalsh(M: torch.Tensor) -> torch.Tensor:
    """The step's symmetric eigenvalues, ascending (the routes of eigh)."""
    if M.shape[-1] != 3 and not M.is_cuda:
        return torch.linalg.eigvalsh(M)
    return eigh(M)[0]
