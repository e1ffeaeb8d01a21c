"""Batched, branch-free SO(3)/SE(3) Lie ops (counterpart of the JAX package's ops/se3.py).

6D pose = [trans(3), rotvec(3)]; small-angle Taylor blends via torch.where;
near-pi handling through a softmax-weighted axis extraction in so3_log.
Every function broadcasts over arbitrary leading batch dims and keeps the
input dtype.

The maps the step calls, so3_exp, so3_log, se3_exp, se3_log, se3_compose,
se3_inverse, se3_relative and skew, are the custom operator `gcslam::lie`
(`lie`), and linalg.inv3x3 is `gcslam::inv3x3` beside them: on a CPU
tensor each runs its plain version (`<name>_reference`, a chain of small
torch ops) unchanged; on a CUDA tensor each is one launch (`launch`) of
csrc/se3.cu's lie_kernel, one thread per element of the broadcast batch
(outputs from torch.empty, inputs read through their strides, no host
sync, so a CUDA graph captures it), where the plain version is 17-195
kernels. A CUDA tensor goes to the kernel or raises. A vmap rule folds the
vmapped dims into the batch (parallel/sweep vmaps scan_step), so a vmapped
call is one launch. LIE_COUNTER records each launch by ((op,) + batch
shape, dtype). The kernel is compiled with nvcc on first use into
csrc/build/ (ops/cuda_build.py), with --fmad=false: each element performs
its plain version's IEEE operations, its sums of three terms and the
entries of its 3 x 3 products left to right. Where the plain version goes
through a product or a reduction, whose order torch and cuBLAS choose, an
output may part from it in the last bits.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from gcslam_torch.ops.cuda_build import KernelLibrary, LaunchCounter

SMALL_ANGLE = 1e-7
MAX_DIMS = 8  # batch dims a launch (csrc/se3.cu kMaxDims)
# csrc/se3.cu's ops in its order (gcslam::lie's, and inv3x3, which is
# ops/linalg.py's gcslam::inv3x3): the trailing shapes of the input, the
# second input (None: none) and the output
OPS = {
    "so3_exp": ((3,), None, (3, 3)),
    "so3_log": ((3, 3), None, (3,)),
    "se3_exp": ((6,), None, (6,)),
    "se3_log": ((6,), None, (6,)),
    "se3_compose": ((6,), (6,), (6,)),
    "se3_inverse": ((6,), None, (6,)),
    "se3_relative": ((6,), (6,), (6,)),
    "skew": ((3,), None, (3, 3)),
    "inv3x3": ((3, 3), None, (3, 3)),
}
_CODES = {name: code for code, name in enumerate(OPS)}
_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                                  ctypes.c_double, ctypes.c_void_p]
# --fmad=false: no multiply-add contraction, the plain versions' IEEE operations
_KERNEL = KernelLibrary("se3.cu", "gcslam_se3", {"gcslam_lie_f32": _ARGS, "gcslam_lie_f64": _ARGS},
                        extra_flags=["--fmad=false"])
LIE_COUNTER = LaunchCounter()


def build():
    """Compile csrc/se3.cu into csrc/build/ unless that library exists;
    returns its path."""
    return _KERNEL.build()


def library_path():
    return _KERNEL.path()


def load():
    """The loaded library (csrc/se3.cu built first if needed)."""
    return _KERNEL.lib()


def build_log() -> str:
    """nvcc's output of the build made by this process ('' if none was needed)."""
    return _KERNEL.build_log


def launches_by_op(since=None) -> dict:
    """LIE_COUNTER's launches by op since `since` (a LIE_COUNTER.snapshot();
    default: its last reset). Reading against a snapshot leaves the counter
    to its other readers."""
    by_instance = LIE_COUNTER.by_instance - (since[1] if since else collections.Counter())
    out = collections.Counter()
    for (_, key), n in by_instance.items():
        out[key[0]] += n
    return dict(out)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcasting matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def skew_reference(v: torch.Tensor) -> torch.Tensor:
    """[v]x for (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of skew for (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta(phi: torch.Tensor):
    theta_sq = torch.sum(phi * phi, dim=-1)
    return torch.sqrt(theta_sq), theta_sq


def so3_exp_reference(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotvec -> (..., 3, 3) rotation."""
    theta, theta_sq = _theta(omega)
    K = skew_reference(omega)
    K_sq = K @ K
    small = theta < SMALL_ANGLE
    safe_t = torch.where(small, 1.0, theta)
    safe_t2 = torch.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    A = torch.where(small, 1.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5, (1.0 - torch.cos(safe_t)) / safe_t2)
    return eye3(omega) + A[..., None, None] * K + B[..., None, None] * K_sq


def so3_log_reference(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3) rotvec (small-angle /
    generic / near-pi blend, same formulas as the JAX package)."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    vex = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.linalg.vector_norm(vex, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)

    omega_small = vex
    safe_sin = torch.where(sin_theta < SMALL_ANGLE, 1.0, sin_theta)
    omega_general = (theta / safe_sin)[..., None] * vex

    S_sym = 0.5 * (R + R.transpose(-1, -2))
    one_minus_c = torch.clamp(1.0 - cos_theta, min=SMALL_ANGLE)[..., None, None]
    outer = (S_sym - cos_theta[..., None, None] * eye3(R)) / one_minus_c
    diag = torch.diagonal(outer, dim1=-2, dim2=-1)
    w = torch.softmax(50.0 * diag, dim=-1)
    axis_col = mv(outer, w)
    axis_norm = torch.linalg.vector_norm(axis_col, dim=-1, keepdim=True)
    safe_norm = torch.where(axis_norm < SMALL_ANGLE, 1.0, axis_norm)
    axis = axis_col / safe_norm
    sign = torch.where(torch.sum(axis * vex, dim=-1, keepdim=True) >= 0.0, 1.0, -1.0)
    omega_pi = axis * sign * theta[..., None]

    is_small = (theta < SMALL_ANGLE)[..., None]
    is_near_pi = ((cos_theta < 0.0) & (sin_theta < 1e-5))[..., None]
    return torch.where(is_small, omega_small, torch.where(is_near_pi, omega_pi, omega_general))


def _BC_coeffs(theta, theta_sq):
    small = theta < SMALL_ANGLE
    safe_t = torch.where(small, 1.0, theta)
    safe_t2 = torch.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    safe_t3 = safe_t2 * safe_t
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (safe_t - torch.sin(safe_t)) / safe_t3)
    return B, C


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Jr(phi) = I - B [phi]x + C [phi]x^2 (reference se3_jax.py:68-103)."""
    theta, theta_sq = _theta(phi)
    K = skew_reference(phi)
    B, C = _BC_coeffs(theta, theta_sq)
    return eye3(phi) - B[..., None, None] * K + C[..., None, None] * (K @ K)


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Jr^{-1}(phi) = I + 1/2 [phi]x + D [phi]x^2 (reference se3_jax.py:107-134)."""
    theta, theta_sq = _theta(phi)
    K = skew_reference(phi)
    eps = 1e-12
    denom = 2.0 * theta * torch.sin(theta) + eps
    D = torch.where(
        theta < 1e-4,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / (theta_sq + eps) - (1.0 + torch.cos(theta)) / denom,
    )
    return eye3(phi) + 0.5 * K + D[..., None, None] * (K @ K)


def se3_V(phi: torch.Tensor) -> torch.Tensor:
    theta, theta_sq = _theta(phi)
    K = skew_reference(phi)
    B, C = _BC_coeffs(theta, theta_sq)
    return eye3(phi) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def se3_V_inv(phi: torch.Tensor) -> torch.Tensor:
    theta, theta_sq = _theta(phi)
    K = skew_reference(phi)
    eps = 1e-12
    small = theta < SMALL_ANGLE
    safe_t = torch.where(small, 1.0, theta)
    safe_t2 = torch.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    denom = 2.0 * safe_t * torch.sin(safe_t) + eps
    D = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / safe_t2 - (1.0 + torch.cos(safe_t)) / denom,
    )
    return eye3(phi) - 0.5 * K + D[..., None, None] * (K @ K)


def se3_exp_reference(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rho, phi] -> 6D pose [t, rotvec] with t = V(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    return torch.cat([mv(se3_V(phi), rho), phi], dim=-1)


def se3_log_reference(pose: torch.Tensor) -> torch.Tensor:
    """6D pose [t, rotvec] -> se(3) twist [V(phi)^-1 t, phi], phi = so3_log(so3_exp(rotvec))."""
    t, rotvec = pose[..., :3], pose[..., 3:6]
    phi = so3_log_reference(so3_exp_reference(rotvec))
    return torch.cat([mv(se3_V_inv(phi), t), phi], dim=-1)


def se3_compose_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T_a o T_b for 6D poses [t, rotvec]."""
    Ra = so3_exp_reference(a[..., 3:6])
    Rb = so3_exp_reference(b[..., 3:6])
    t = a[..., :3] + mv(Ra, b[..., :3])
    return torch.cat([t, so3_log_reference(Ra @ Rb)], dim=-1)


def se3_inverse_reference(a: torch.Tensor) -> torch.Tensor:
    """T_a^{-1} for a 6D pose [t, rotvec]."""
    R_inv = so3_exp_reference(a[..., 3:6]).transpose(-1, -2)
    return torch.cat([-mv(R_inv, a[..., :3]), so3_log_reference(R_inv)], dim=-1)


def se3_relative_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b^{-1} o a."""
    return se3_compose_reference(se3_inverse_reference(b), a)


_REFERENCES = {"so3_exp": so3_exp_reference, "so3_log": so3_log_reference, "se3_exp": se3_exp_reference,
               "se3_log": se3_log_reference, "se3_compose": se3_compose_reference,
               "se3_inverse": se3_inverse_reference, "se3_relative": se3_relative_reference,
               "skew": skew_reference}


def lie_reference(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the Lie map `op` on a, and b for the two-pose ops."""
    return _REFERENCES[op](a) if b is None else _REFERENCES[op](a, b)


# --- the kernel -----------------------------------------------------------------

def _check(op: str, x: torch.Tensor, tail: tuple) -> None:
    if x.dim() < len(tail) or tuple(x.shape[x.dim() - len(tail):]) != tail:
        raise ValueError(f"{op}: expected (..., {', '.join(map(str, tail))}), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{op}: expected float32 or float64, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"{op}: the kernel takes CUDA tensors")


def batch_shape(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> tuple:
    """The broadcast batch of a call of `op` (a name of OPS) on a (and b)."""
    tail_a, tail_b, _ = OPS[op]
    batch = tuple(a.shape[:a.dim() - len(tail_a)])
    if b is not None:
        batch = tuple(torch.broadcast_shapes(batch, b.shape[:b.dim() - len(tail_b)]))
    return batch


def _layout(batch: tuple, a: torch.Tensor, b: Optional[torch.Tensor]):
    """csrc/se3.cu's meta array: the batch's sizes, a's and b's strides over
    the batch, then over their own trailing dims (two each, 0-padded)."""
    nd = len(batch)
    meta = (ctypes.c_longlong * (3 * MAX_DIMS + 4))()
    meta[:nd] = batch
    meta[MAX_DIMS:MAX_DIMS + nd] = a.stride()[:nd]
    meta[3 * MAX_DIMS:3 * MAX_DIMS + 2] = (a.stride()[nd:] + (0, 0))[:2]
    if b is not None:
        meta[2 * MAX_DIMS:2 * MAX_DIMS + nd] = b.stride()[:nd]
        meta[3 * MAX_DIMS + 2:] = (b.stride()[nd:] + (0, 0))[:2]
    return meta


def launch(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None, eps: float = 0.0) -> torch.Tensor:
    """One launch of csrc/se3.cu's kernel for `op` (a name of OPS) over the
    broadcast batch of the CUDA tensors a (and b): the operands expanded
    to it as views (a broadcast dim has stride 0), the output contiguous
    from torch.empty; eps is inv3x3's lift. The CUDA kernel of gcslam::lie
    and of gcslam::inv3x3."""
    tail_a, tail_b, tail_out = OPS[op]
    _check(op, a, tail_a)
    if tail_b is not None:
        _check(op, b, tail_b)
        if b.dtype != a.dtype or b.device != a.device:
            raise TypeError(f"{op}: operands of {a.dtype} on {a.device} and {b.dtype} on {b.device}")
    batch = batch_shape(op, a, b)
    if len(batch) > MAX_DIMS:
        raise ValueError(f"{op}: at most {MAX_DIMS} batch dims a launch, got {len(batch)}")
    a = a.expand(batch + tail_a)
    b = None if tail_b is None else b.expand(batch + tail_b)
    out = torch.empty(batch + tail_out, dtype=a.dtype, device=a.device)
    n = math.prod(batch)
    if n:
        lib = _KERNEL.lib()
        fn = lib.gcslam_lie_f64 if a.dtype == torch.float64 else lib.gcslam_lie_f32
        with torch.cuda.device(a.device):
            err = fn(_CODES[op], a.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), n,
                     _layout(batch, a, b), len(batch), eps, torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{op} kernel launch failed: cudaError_t {err}")
        LIE_COUNTER.count((op,) + batch, a.dtype)
    return out


@torch.library.custom_op("gcslam::lie", mutates_args=(), device_types="cpu")
def _lie_op(op: str, a: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return lie_reference(op, a, b)


@_lie_op.register_kernel("cuda")
def _lie_cuda(op, a, b):
    return launch(op, a, b)


@_lie_op.register_vmap
def _lie_vmap(info, in_dims, op, a, b):
    """The vmapped dim leads the batch, in front of the operands' broadcast
    batch dims: one call (on CUDA one launch) for every element of every run;
    an unbatched operand broadcasts."""
    _, d_a, d_b = in_dims
    if d_a is None and d_b is None:
        return _lie_op(op, a, b), None
    tail_a, tail_b, _ = OPS[op]
    n_a = a.dim() - (d_a is not None) - len(tail_a)
    n_b = 0 if b is None else b.dim() - (d_b is not None) - len(tail_b)

    def leading(x, d, n):
        return x if d is None else x.movedim(d, 0)[(slice(None),) + (None,) * (max(n_a, n_b) - n)]

    return _lie_op(op, leading(a, d_a, n_a), None if b is None else leading(b, d_b, n_b)), 0


def lie(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Lie map `op` (a name of OPS but inv3x3) on a, and b for the
    two-pose ops: one launch of csrc/se3.cu on CUDA tensors, the plain
    version on CPU tensors."""
    return _lie_op(op, a, b)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[v]x for (..., 3) -> (..., 3, 3)."""
    return lie("skew", v)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotvec -> (..., 3, 3) rotation."""
    return lie("so3_exp", omega)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3) rotvec."""
    return lie("so3_log", R)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rho, phi] -> 6D pose [t, rotvec] with t = V(phi) rho."""
    return lie("se3_exp", xi)


def se3_log(pose: torch.Tensor) -> torch.Tensor:
    """6D pose [t, rotvec] -> se(3) twist [rho, phi]."""
    return lie("se3_log", pose)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T_a o T_b for 6D poses [t, rotvec]."""
    return lie("se3_compose", a, b)


def se3_inverse(a: torch.Tensor) -> torch.Tensor:
    """T_a^{-1} for a 6D pose [t, rotvec]."""
    return lie("se3_inverse", a)


def se3_relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b^{-1} o a."""
    return lie("se3_relative", a, b)


def se3_plus(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Retraction: T(x) o T(delta) where delta is a 6D pose increment."""
    return se3_compose(x, delta)


def se3_minus(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """delta such that x2 (+) delta = x1 (pose difference, not twist)."""
    return se3_relative(x1, x2)


def se3_adjoint(xi: torch.Tensor) -> torch.Tensor:
    """Ad_T (6x6) for pose [t, rotvec] acting on twists [rho, phi]:
    Ad = [[R, [t]x R], [0, R]], so that Exp(Ad_T xi) = T Exp(xi) T^{-1}."""
    R = so3_exp(xi[..., 3:6])
    tR = skew(xi[..., :3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_cov_compose(cov_a: torch.Tensor, cov_b: torch.Tensor, T_a: torch.Tensor) -> torch.Tensor:
    """Compose covariances under T_out = T_a o T_b."""
    Ad = se3_adjoint(T_a)
    return cov_a + Ad @ cov_b @ Ad.transpose(-1, -2)


def se3_identity(dtype=None, device=None) -> torch.Tensor:
    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    return torch.zeros(6, dtype=dtype or BELIEF_DTYPE, device=device)


def apply_pose_to_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """p' = R p + t for pose (..., 6) and points (..., N, 3)."""
    R = so3_exp(pose[..., 3:6])
    return torch.einsum("...ij,...nj->...ni", R, points) + pose[..., None, :3]
