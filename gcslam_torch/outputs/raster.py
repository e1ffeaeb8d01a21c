"""Front-to-back splat compositing: the hand-written CUDA kernel
(csrc/raster.cu, replacing the TPU Pallas kernel of the JAX package's
outputs/rendering_pallas.py) and its plain PyTorch version.

`composite_splats` takes depth-sorted screen splats
(rendering.prepare_screen_splats) and returns the raw accumulators
rgb (H, W, 3), depth (H, W) and transmittance T (H, W). On CUDA tensors it
launches the kernel or raises; on CPU tensors it runs
`composite_splats_reference`, a loop over splats over the whole image.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gcslam_torch.ops.cuda_build import KernelLibrary, LaunchCounter


class ScreenSplats(NamedTuple):
    """Depth-sorted per-splat screen parameters, all float32."""

    u0: torch.Tensor  # (P,) centre, pixels
    v0: torch.Tensor  # (P,)
    inv2: torch.Tensor  # (P, 3) inverse 2-D covariance (a, b, c) = [[a, b], [b, c]]
    rgb: torch.Tensor  # (P, 3) shaded colour
    alpha: torch.Tensor  # (P,) opacity (0 behind the camera)
    z: torch.Tensor  # (P,) camera depth
    radius: torch.Tensor  # (P,) clip radius: w = 0 beyond it, pixels


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 4
# --fmad=false: no multiply-add contraction, so each pixel does the plain
# version's IEEE operations in its order
_KERNEL = KernelLibrary("raster.cu", "gcslam_raster", {"gcslam_raster_f32": _ARGS},
                        extra_flags=["--fmad=false"])
COUNTER = LaunchCounter()


def build():
    """Compile csrc/raster.cu into csrc/build/ unless that library exists;
    returns its path."""
    return _KERNEL.build()


def library_path():
    """Where build() puts the library (it exists once built)."""
    return _KERNEL.path()


def load():
    """The loaded library (csrc/raster.cu built first if needed)."""
    return _KERNEL.lib()


def build_log() -> str:
    """nvcc's output of the build made by this process ('' if none was needed)."""
    return _KERNEL.build_log


def composite_splats_reference(s: ScreenSplats, height: int, width: int,
                               log_clip: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch compositor: one pass over the whole image per splat,
    front to back (the scan compositor of the JAX package's
    outputs/rendering.render_splats)."""
    f32 = torch.float32
    dev = s.u0.device
    us = torch.arange(width, dtype=f32, device=dev)[None, :]
    vs = torch.arange(height, dtype=f32, device=dev)[:, None]
    rgb = torch.zeros(height, width, 3, dtype=f32, device=dev)
    depth = torch.zeros(height, width, dtype=f32, device=dev)
    T = torch.ones(height, width, dtype=f32, device=dev)
    b2 = 2.0 * s.inv2[:, 1]
    for p in range(s.u0.shape[0]):
        du = us - s.u0[p]
        dv = vs - s.v0[p]
        q = -0.5 * (s.inv2[p, 0] * du * du + b2[p] * du * dv + s.inv2[p, 2] * dv * dv)
        w = torch.where(q > log_clip, torch.exp(q), 0.0) * s.alpha[p]
        contrib = w * T
        rgb = rgb + contrib[..., None] * s.rgb[p]
        depth = depth + contrib * s.z[p]
        T = T * (1.0 - w)
    return rgb, depth, T


def _check(s: ScreenSplats, height: int, width: int) -> None:
    P = s.u0.shape[0]
    shapes = {"u0": (P,), "v0": (P,), "inv2": (P, 3), "rgb": (P, 3), "alpha": (P,), "z": (P,), "radius": (P,)}
    for name, shape in shapes.items():
        x = getattr(s, name)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not (x.is_cuda and x.device == s.u0.device):
            raise ValueError("all splat tensors must lie on one CUDA device")
    if not (height >= 1 and width >= 1 and 3 * height * width < 2**31 and P < 2**31):
        raise ValueError(f"unsupported image {height} x {width} or splat count {P}")


def composite_splats(s: ScreenSplats, height: int, width: int,
                     log_clip: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rgb (H, W, 3), depth (H, W), T (H, W)) accumulators: the kernel on
    CUDA tensors, the plain loop on CPU tensors."""
    if s.u0.device.type == "cpu":
        return composite_splats_reference(s, height, width, log_clip)
    _check(s, height, width)
    lib = _KERNEL.lib()
    dev = s.u0.device
    rgb = torch.empty(height, width, 3, dtype=torch.float32, device=dev)
    depth = torch.empty(height, width, dtype=torch.float32, device=dev)
    T = torch.empty(height, width, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gcslam_raster_f32(
            s.u0.data_ptr(), s.v0.data_ptr(), s.inv2.data_ptr(), s.rgb.data_ptr(), s.alpha.data_ptr(),
            s.z.data_ptr(), s.radius.data_ptr(), s.u0.shape[0], height, width, float(log_clip),
            rgb.data_ptr(), depth.data_ptr(), T.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError_t {err}")
    COUNTER.launches += 1
    return rgb, depth, T
