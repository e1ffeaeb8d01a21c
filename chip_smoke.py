"""Smoke test of the PyTorch/CUDA port (gcslam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device: a CUDA card is required (no CPU fallback); prints its name and
     `nvidia-smi` name + power limit;
  2. kernels: builds csrc/sinkhorn.cu with nvcc, runs it against its plain
     PyTorch version on the card at the main path's shapes (f32 and f64,
     a third of the rows at zero mass) and times both;
  3. main path: runner.run_bag over 50 synthetic scans of 8192 points at
     PipelineConfig() defaults; finite poses, ATE gate of bench.py
     (<= 0.30 m, <= 4.0 deg, initial-pose alignment), and exactly
     map_icp_iters x n_scans Sinkhorn launches;
  4. determinism: two 10-scan runs give bit-equal poses.
Before the last line it prints {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_SCANS = 50
N_POINTS = 8192
N_WARMUP = 5
N_DETERMINISM = 10
GATE_ATE_TRANS_RMSE_M = 0.30
GATE_ATE_ROT_RMSE_DEG = 4.0
SINKHORN_CASES = [(1, 1024, 8), (4, 1024, 8), (1, 1536, 8), (1, 257, 8)]
SINKHORN_ARGS = dict(epsilon=0.05, tau_a=1.0, tau_b=1.0, n_iters=50)
TOL = {"float32": dict(rtol=2e-5, atol=1e-7), "float64": dict(rtol=1e-10, atol=1e-30)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sinkhorn_inputs(B: int, N: int, K: int, dtype, device, seed: int):
    """Cost uniform in [0, 5), a third of the rows at zero mass, uniform b."""
    import torch

    rng = np.random.default_rng(seed)
    C = rng.uniform(0.0, 5.0, size=(B, N, K))
    valid = rng.uniform(size=(B, N)) > 0.33
    a = valid / np.maximum(valid.sum(-1, keepdims=True), 1e-9)
    b = np.full((B, K), 1.0 / K)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    if B == 1:
        return to(C[0]), to(a[0]), to(b[0]), ~valid[0]
    return to(C), to(a), to(b), ~valid


def time_call(fn, n: int = 50) -> float:
    """ms per call by CUDA events after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def ptxas_summary(log: str):
    """One line per compiled kernel instance from nvcc's -Xptxas -v output:
    template arguments, registers, spill stores."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"sinkhorn_kernelI([fd])Li(\d+)ELi(\d+)E", m.group(1))
            name = (f"sinkhorn_kernel<{'float' if t.group(1) == 'f' else 'double'}, KMAX={t.group(2)}, "
                    f"RMAX={t.group(3)}>") if t else m.group(1)
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return out


def phase_kernels(device):
    """Kernel vs plain on the card; returns the main-path-shape record."""
    import torch
    from gcslam_torch.ops import sinkhorn

    t0 = time.perf_counter()
    lib_path = sinkhorn.build()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(sinkhorn.build_log()):
        print("  ptxas:", line)
    record = None
    max_err_main = 0.0
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for case_i, (B, N, K) in enumerate(SINKHORN_CASES):
            C, a, b, zero_rows = sinkhorn_inputs(B, N, K, dtype, device, seed=N + case_i)
            out = sinkhorn.sinkhorn_unbalanced(C, a, b, **SINKHORN_ARGS)
            ref = sinkhorn.sinkhorn_unbalanced_reference(C, a, b, **SINKHORN_ARGS)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"sinkhorn {name} {(B, N, K)}: non-finite output")
            if out[torch.as_tensor(zero_rows, device=device)].abs().max() != 0:
                fail(f"sinkhorn {name} {(B, N, K)}: zero-mass rows are not exactly 0")
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, **TOL[name]):
                fail(f"sinkhorn {name} {(B, N, K)}: max |err| {err:.3e} outside {TOL[name]}")
            ms = time_call(lambda: sinkhorn.sinkhorn_unbalanced(C, a, b, **SINKHORN_ARGS))
            plain_ms = time_call(lambda: sinkhorn.sinkhorn_unbalanced_reference(C, a, b, **SINKHORN_ARGS))
            print(f"sinkhorn {name} B={B} N={N} K={K}: max|err| {err:.3e} "
                  f"kernel {ms * 1e3:.1f} us/call, plain {plain_ms * 1e3:.1f} us/call")
            if (B, N, K) == (1, 1024, 8):
                max_err_main = max(max_err_main, err)
                if dtype == torch.float64:  # the main path's dtype
                    record = dict(ms=ms, plain_ms=plain_ms)
    record["max_abs_err"] = max_err_main
    return record


def phase_main_path(device, cfg):
    """run_bag on the synthetic world; returns (launches, ms/scan, ATE dict, run)."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.ops import sinkhorn

    n_scans, n_points = N_SCANS, N_POINTS
    t0 = time.perf_counter()
    run = generate(SyntheticConfig(n_scans=n_scans, n_points=n_points))
    print(f"generated {n_scans} scans x {n_points} points in {time.perf_counter() - t0:.1f} s")

    runner.run_bag(run.batches[:N_WARMUP], cfg, device=device)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    sinkhorn.COUNTER.reset()
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sinkhorn.COUNTER.launches

    poses = out.pose.cpu().numpy()
    if poses.shape != (n_scans, 6) or not np.all(np.isfinite(poses)):
        fail(f"poses not finite or of wrong shape {poses.shape}")
    ate = compute_ate(poses, run.gt_poses, align="initial")
    ms_scan = 1e3 * elapsed / n_scans
    print(f"main path: {ms_scan:.2f} ms/scan over {n_scans} scans (after {N_WARMUP} warm-up scans); "
          f"ATE {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg; "
          f"sinkhorn launches {launches}")
    return launches, ms_scan, ate, run


def phase_determinism(device, run, cfg) -> None:
    import torch
    from gcslam_torch.models import runner

    n = N_DETERMINISM
    _, o1 = runner.run_bag(run.batches[:n], cfg, device=device)
    _, o2 = runner.run_bag(run.batches[:n], cfg, device=device)
    if not torch.equal(o1.pose, o2.pose):
        fail(f"repeat runs differ: max |dpose| {(o1.pose - o2.pose).abs().max().item():.3e}")
    print(f"determinism: two {n}-scan runs give bit-equal poses")


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(nvidia_smi_line())

    from gcslam_torch.models.config import PipelineConfig

    # 2. kernels against their plain versions
    record = phase_kernels(device)

    # 3. the main path
    cfg = PipelineConfig()
    launches, ms_scan, ate, run = phase_main_path(device, cfg)
    expected = cfg.map_icp_iters * N_SCANS
    if launches != expected:
        fail(f"sinkhorn launched {launches} times on the main path, expected {expected}")
    if ate["translation"]["rmse"] > GATE_ATE_TRANS_RMSE_M or ate["rotation_deg"]["rmse"] > GATE_ATE_ROT_RMSE_DEG:
        fail(f"ATE gate: {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg")

    # 4. determinism
    phase_determinism(device, run, cfg)

    kernels = [dict(
        name="sinkhorn_unbalanced",
        route="cuda",
        source="gcslam_torch/csrc/sinkhorn.cu",
        replaces="gcslam_tpu/ops/sinkhorn_pallas.py:59",
        launches=launches,
        max_abs_err=record["max_abs_err"],
        ms=record["ms"],
        plain_ms=record["plain_ms"],
    )]
    print(json.dumps({"main_path": {"ms_per_scan": ms_scan, "n_scans": N_SCANS, "n_points": N_POINTS,
                                    "ate_m": ate["translation"]["rmse"],
                                    "ate_deg": ate["rotation_deg"]["rmse"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
