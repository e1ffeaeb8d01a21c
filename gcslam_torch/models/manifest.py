"""RuntimeManifest (counterpart of the JAX package's models/manifest.py):
every behavioural setting, emitted as JSON at startup ("no silent
defaults", reference backend/pipeline.py:1629-1793): chart, dtypes,
budgets, epsilons, backends, the frontend's native or Python route, every
config field, and the device the run is on. compute_cert measures one
call of the step where the JAX package reads XLA's cost and memory
analysis of the compiled program; its compile-cache counts have no
counterpart here and are left out."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import torch

from gcslam_torch import constants as C
from gcslam_torch.frontend.native import native_by_default
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.utils.dtypes import BELIEF_DTYPE, POINT_DTYPE, TIME_DTYPE

BACKENDS = {
    "core_array": "torch (eager scan_step, one host loop over scans)",
    "se3": "gcslam_torch.ops.se3 (batched, atan2 log, symmetric near-pi axis)",
    "domain_projection_psd": "gcslam_torch.ops.linalg.domain_projection_psd",
    "lifted_spd_solve": "gcslam_torch.ops.linalg.spd_solve_lifted",
    "lifted_spd_inverse": "gcslam_torch.ops.linalg.spd_inverse_lifted",
    "process_noise_model": "gcslam_torch.ops.iw (blockwise IW, commutative per-scan)",
    "measurement_noise_model": "gcslam_torch.ops.iw (per-sensor IW: gyro/accel/lidar)",
    "imu_preintegration": "gcslam_torch.ops.preintegration",
    "deskew": "gcslam_torch.ops.deskew (constant twist, f32 point path)",
    "imu_evidence": "gcslam_torch.ops.evidence_imu (vMF gravity Laplace, time-resolved)",
    "odom_evidence": "gcslam_torch.ops.evidence_odom (Gaussian SE(3) factor)",
    "lidar_evidence": "gcslam_torch.ops.evidence_pose (primitive alignment at z_lin)",
    "surfel_extraction": "gcslam_torch.ops.surfels (scatter-add moments + batched eigh)",
    "association": "gcslam_torch.ops.association (shortlist cost + unbalanced Sinkhorn)",
    "hypothesis_barycenter": "gcslam_torch.ops.hypothesis (batched info barycenter)",
    "map_backend": "gcslam_torch.models.atlas (device-resident tiled SoA)",
    "sinkhorn_backend": "gcslam_torch/csrc/sinkhorn.cu on CUDA tensors, the plain loop on CPU tensors",
    "frontend": "gcslam_torch.frontend (offline bag reader with the native decoder / synthetic rig)",
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def device_runtime_cert(device) -> Dict[str, Any]:
    """The device the run is on: platform, the CUDA inventory (name, count,
    compute capability) when it is the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "n_devices": 1, "device_kinds": [dev.type]}
    n = torch.cuda.device_count()
    return {
        "platform": "cuda",
        "n_devices": n,
        "device_kinds": sorted({torch.cuda.get_device_name(i) for i in range(n)}),
        "capability": [".".join(map(str, torch.cuda.get_device_capability(i))) for i in range(n)],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def runtime_manifest(cfg: PipelineConfig) -> Dict[str, Any]:
    m: Dict[str, Any] = {
        "chart_id": C.CHART_ID,
        "belief_dtype": _dtype_name(BELIEF_DTYPE),
        "point_dtype": _dtype_name(POINT_DTYPE),
        "time_dtype": _dtype_name(TIME_DTYPE),
        "D_Z": C.D_Z,
        "D_DESKEW": C.D_DESKEW,
        "HYP_WEIGHT_FLOOR": C.HYP_WEIGHT_FLOOR,
        "MAX_IMU_PREINT_LEN": C.MAX_IMU_PREINT_LEN,
        "VMF_N_LOBES": C.VMF_N_LOBES,
        "N_ACTIVE_TILES": C.N_ACTIVE_TILES,
        "N_STENCIL_TILES": C.N_STENCIL_TILES,
        "pose_evidence_backend": C.POSE_EVIDENCE_BACKEND,
        "map_backend": C.MAP_BACKEND,
        "backends": dict(BACKENDS),
        "gravity_w": list(C.GRAVITY_W),
        "iw_rho_process": [C.IW_RHO_TRANS, C.IW_RHO_ROT, C.IW_RHO_VEL, C.IW_RHO_BG,
                           C.IW_RHO_BA, C.IW_RHO_DT, C.IW_RHO_EX],
        "iw_rho_measurement": [C.IW_RHO_MEAS_GYRO, C.IW_RHO_MEAS_ACCEL, C.IW_RHO_MEAS_LIDAR],
        # the frontend's route when no caller names one (GCSLAM_NO_NATIVE=1: Python)
        "frontend_route": "native" if native_by_default() else "python",
    }
    # every config field is behavioural -> all of them go in the manifest
    m.update({f"config.{k}": v for k, v in dataclasses.asdict(cfg).items()})
    return m


def compute_cert(fn, *args) -> Dict[str, Any]:
    """ComputeCert (counterpart of the JAX package's compute_cert, reference
    certificates.py:318-360), measured on one call fn(*args):
      - matmul_flops: the FLOPs torch.utils.flop_counter.FlopCounterMode
        counts. It counts matrix products and convolutions only: the
        elementwise work, reductions, sorts, scatters, factorizations and
        the Sinkhorn kernel are left out, so this is a floor on the call's
        FLOPs, not XLA's whole-program count;
      - argument_bytes / output_bytes: the bytes of the tensors in `args`
        and in the result;
      - peak_allocated_bytes: the card's peak allocated memory during the
        call (torch.cuda.max_memory_allocated after
        reset_peak_memory_stats), arguments included, and
        peak_above_start_bytes, that peak less what was allocated when the
        call began (the call's own working set and outputs). Both None when
        the arguments are not on the card.
    Returns (cert, the call's result)."""
    from torch.utils.flop_counter import FlopCounterMode

    from gcslam_torch.utils.tree import tree_leaves

    leaves = tree_leaves(list(args))
    dev = next((x.device for x in leaves if x.is_cuda), None)
    if dev is not None:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    cert: Dict[str, Any] = {
        "matmul_flops": int(counter.get_total_flops()),
        "argument_bytes": int(sum(x.nbytes for x in leaves)),
        "output_bytes": int(sum(x.nbytes for x in tree_leaves(out))),
        "peak_allocated_bytes": None,
        "peak_above_start_bytes": None,
    }
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        cert.update(peak_allocated_bytes=int(peak), peak_above_start_bytes=int(peak - start))
    return cert, out


def manifest_json(cfg: PipelineConfig, device) -> str:
    m = runtime_manifest(cfg)
    m["device_runtime"] = device_runtime_cert(device)
    return json.dumps(m, indent=2, sort_keys=True)


def write_manifest(path: str, cfg: PipelineConfig, device) -> None:
    with open(path, "w") as f:
        f.write(manifest_json(cfg, device))
