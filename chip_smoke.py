"""Smoke test of the PyTorch/CUDA port (gcslam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device: a CUDA card is required (no CPU fallback); prints its name and
     `nvidia-smi` name + power limit;
  2. kernels: builds csrc/sinkhorn.cu and csrc/raster.cu with nvcc (one
     process each, started together) and holds each kernel against its
     plain PyTorch version on the card at the main paths' shapes: Sinkhorn
     in f32 and f64 with a third of the rows at zero mass, the launcher's
     cluster size per shape (checked against ops/sinkhorn.cluster_layout),
     two launches bit-equal; the splat rasterizer at P = 4096 on 240 x 320
     and 360 x 480 (max |d rgb| <= 1e-5, relative depth error <= 1e-4 where
     coverage 1 - T >= 0.01, finite, > 20 % of pixels drawn, two launches
     bit-equal, and the (pixel, splat) pairs it composites); times both by
     CUDA events over back-to-back calls and by the kernel's own device
     time in torch.profiler; prints ptxas registers, spills and shared
     memory;
  3. flagship path: runner.run_bag over 50 synthetic scans of 8192 points
     at PipelineConfig() defaults; finite poses, ATE gate of bench.py
     (<= 0.30 m, <= 4.0 deg, initial-pose alignment), and exactly
     map_icp_iters x n_scans Sinkhorn launches;
  4. determinism: two 10-scan flagship runs give bit-equal poses;
  5. camera path: generate(with_camera=True) and run_bag at
     PipelineConfig(with_camera=True) over 50 scans at production budgets;
     finite poses, the camera ATE gate of bench.py (<= 0.30 m, <= 4.0 deg),
     exactly map_icp_iters x n_scans Sinkhorn launches, all at
     N = n_surfel + n_feat = 1536 rows;
  6. render: render_atlas of the camera run's map at RenderParams() from
     the final pose (composed with the rig's base->camera extrinsic) and
     from the viewer's overview vantage, each twice: one raster launch per
     render, finite, bit-equal repeats, the kernel against the plain
     compositor on the same splats;
  7. viewer: splat_export + TUM trajectory of the camera run, then
     tools/view_splats on them (last pose and overview), .npy outputs.
Before the last line it prints {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Files go to results/chip_smoke/.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_SCANS = 50
N_POINTS = 8192
N_WARMUP = 5
N_DETERMINISM = 10
GATE_ATE_TRANS_RMSE_M = 0.30
GATE_ATE_ROT_RMSE_DEG = 4.0
SINKHORN_CASES = [(1, 1024, 8), (4, 1024, 8), (1, 1536, 8), (1, 257, 8), (1, 1, 8), (1, 2048, 8), (4, 129, 20)]
SINKHORN_ARGS = dict(epsilon=0.05, tau_a=1.0, tau_b=1.0, n_iters=50)
TOL = {"float32": dict(rtol=2e-5, atol=1e-7), "float64": dict(rtol=1e-10, atol=1e-30)}
RASTER_CASES = [(4096, 240, 320), (4096, 360, 480)]  # render_atlas at RenderParams(); the viewer
RASTER_RGB_TOL = 1e-5
RASTER_DEPTH_RTOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 and f64 outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
RASTER_FLOPS_PER_PAIR = 21  # ~20 FLOPs and one expf per (pixel, splat) pair with w > 0
OUT_DIR = os.path.join("results", "chip_smoke")


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
    name (template arguments), registers, spill stores, shared memory."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"sinkhorn_kernelI([fd])Li(\d+)E", m.group(1))
            name = (f"sinkhorn_kernel<{'float' if t.group(1) == 'f' else 'double'}, KMAX={t.group(2)}>" if t
                    else "raster_kernel" if "raster_kernel" in m.group(1) else m.group(1))
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {spill}, {smem.group(1) if smem else 0} bytes smem")
            name = None
    return out


def device_ms(fn, kernel: str, n: int = 20):
    """The kernel's own device time per launch (ms), from torch.profiler's
    CUDA activity over n calls; None where the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in rows)
    total_us = sum(e.device_time_total for e in rows)
    return total_us / count / 1e3 if count and total_us else None


def fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    """Both kernels' nvcc builds at once."""
    from gcslam_torch.ops import sinkhorn
    from gcslam_torch.outputs import raster

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        paths = list(pool.map(lambda m: m.build(), (sinkhorn, raster)))
    print(f"built {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    for mod in (sinkhorn, raster):
        for line in ptxas_summary(mod.build_log()):
            print("  ptxas:", line)


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


def sinkhorn_bound(B: int, N: int, K: int, n_iters: int, itemsize: int, peak: float):
    """Bytes: C, a, b read once, the plan written once. Operations: exp(-C/eps)
    and the final diag(u) K diag(v) (3NK), and per iteration two
    matrix-vector products (4NK) and the N + K divide/power updates."""
    n_bytes = itemsize * B * (2 * N * K + N + K)
    n_ops = B * (3 * N * K + n_iters * (4 * N * K + N + K))
    return bound(n_bytes, n_ops, peak)


def phase_sinkhorn(device):
    """Sinkhorn kernel vs plain on the card; returns the records at the
    flagship (1024 rows) and camera-path (1536 rows) shapes, f64."""
    import torch
    from gcslam_torch.ops import sinkhorn

    records = {}
    n_iters = SINKHORN_ARGS["n_iters"]
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for case_i, (B, N, K) in enumerate(SINKHORN_CASES):
            cl, threads = sinkhorn.launcher_layout(N)
            if (cl, threads) != sinkhorn.cluster_layout(N)[::2]:
                fail(f"sinkhorn N={N}: launcher layout {(cl, threads)} != cluster_layout {sinkhorn.cluster_layout(N)}")
            C, a, b, zero_rows = sinkhorn_inputs(B, N, K, dtype, device, seed=N + case_i)
            out = sinkhorn.sinkhorn_unbalanced(C, a, b, **SINKHORN_ARGS)
            out2 = sinkhorn.sinkhorn_unbalanced(C, a, b, **SINKHORN_ARGS)
            ref = sinkhorn.sinkhorn_unbalanced_reference(C, a, b, **SINKHORN_ARGS)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"sinkhorn {name} {(B, N, K)}: non-finite output")
            if not torch.equal(out, out2):
                fail(f"sinkhorn {name} {(B, N, K)}: two launches differ")
            if zero_rows.any() and out[torch.as_tensor(zero_rows, device=device)].abs().max() != 0:
                fail(f"sinkhorn {name} {(B, N, K)}: zero-mass rows are not exactly 0")
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, **TOL[name]):
                fail(f"sinkhorn {name} {(B, N, K)}: max |err| {err:.3e} outside {TOL[name]}")
            call = lambda: sinkhorn.sinkhorn_unbalanced(C, a, b, **SINKHORN_ARGS)  # noqa: E731
            ms = time_call(call)
            plain_ms = time_call(lambda: sinkhorn.sinkhorn_unbalanced_reference(C, a, b, **SINKHORN_ARGS))
            dev_ms = device_ms(call, "sinkhorn_kernel")
            peak = PEAK_F64_PER_S if dtype == torch.float64 else PEAK_F32_PER_S
            bound_ms, bound_by = sinkhorn_bound(B, N, K, n_iters, C.element_size(), peak)
            print(f"sinkhorn {name} B={B} N={N} K={K}: cluster {cl} x {threads} threads, max|err| {err:.3e}, "
                  f"kernel {ms * 1e3:.1f} us/call (events), device {fmt_us(dev_ms)}, plain {plain_ms * 1e3:.1f} "
                  f"us/call, bound {bound_ms * 1e3:.3f} us ({bound_by})")
            if B == 1 and N in (1024, 1536) and dtype == torch.float64:  # the main paths' shapes
                per_iter_us = None if dev_ms is None else 1e3 * dev_ms / n_iters
                records[N] = dict(ms=ms, device_ms=dev_ms, per_iter_us=per_iter_us, cluster=cl, threads=threads,
                                  plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
    return records


def raster_scene(P: int, H: int, W: int, device, seed: int):
    """Screen splats of a seeded random scene (the recipe of
    tests/test_rendering_pallas.py, scaled to the image)."""
    import torch
    from gcslam_torch.outputs import rendering

    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3, 3, (P, 3))
    mu[:, 2] = rng.uniform(2, 8, P)
    A = rng.normal(0, 0.1, (P, 3, 3))
    Sigma = np.einsum("pij,pkj->pik", A, A) + 0.02 * np.eye(3)
    sc = [mu, Sigma, rng.normal(0, 1, (P, 3, 3)), rng.uniform(0, 1, (P, 3)), rng.uniform(0.5, 5, P)]
    params = rendering.RenderParams(width=W, height=H, fx=0.75 * W, fy=0.75 * W)
    s = rendering.prepare_screen_splats(*[torch.as_tensor(x, device=device) for x in sc],
                                        torch.zeros(6, dtype=torch.float64, device=device), params)
    return s, params


def raster_work(s, H: int, W: int, log_clip: float, tile: int = 16):
    """(pairs, box_pairs, warp_share): the (pixel, splat) pairs in the image
    with a nonzero weight (q > log_clip, alpha > 0), the work these inputs
    need; the (pixel, splat) pairs the kernel composites (each tile's pixels
    times the splats whose clip-radius box meets the tile); and the share of
    those tiles' (warp, splat) pairs, a warp being two 16-pixel rows, in
    which some pixel has q > log_clip (the rest the kernel skips)."""
    import torch

    dev = s.u0.device
    ty, tx = -(-H // tile), -(-W // tile)
    x0 = (tile * torch.arange(tx, device=dev, dtype=torch.float32))[None, None, :]
    y0 = (tile * torch.arange(ty, device=dev, dtype=torch.float32))[None, :, None]
    u, v, r, al = (x[:, None, None] for x in (s.u0, s.v0, s.radius, s.alpha))
    hit = ~(~(al > 0) | (u + r < x0) | (u - r > x0 + tile - 1) | (v + r < y0) | (v - r > y0 + tile - 1))
    us = torch.arange(tx * tile, dtype=torch.float32, device=dev)[None, None, :]
    vs = torch.arange(ty * tile, dtype=torch.float32, device=dev)[None, :, None]
    pairs = warp_hits = 0
    for i in range(0, s.u0.shape[0], 64):
        sl = slice(i, i + 64)
        du, dv = us - s.u0[sl, None, None], vs - s.v0[sl, None, None]
        a, b, c = (s.inv2[sl, k, None, None] for k in range(3))
        q = -0.5 * (a * du * du + 2.0 * b * du * dv + c * dv * dv)
        nz = q > log_clip
        pairs += int((nz & (s.alpha[sl, None, None] > 0))[:, :H, :W].sum())
        warp_nz = nz.view(-1, ty, tile // 2, 2, tx, tile).any(5).any(3)  # (splats, ty, warps, tx)
        warp_hits += int((warp_nz & hit[sl, :, None, :]).sum())
    n_hit = int(hit.sum())
    return pairs, n_hit * tile * tile, warp_hits / max(n_hit * tile // 2, 1)


def check_raster(s, H, W, log_clip, label):
    """Kernel vs plain compositor on the same splats; returns max |d rgb|.
    The kernel calls here count as launches."""
    import torch
    from gcslam_torch.outputs import raster

    out1 = raster.composite_splats(s, H, W, log_clip)
    out2 = raster.composite_splats(s, H, W, log_clip)
    ref = raster.composite_splats_reference(s, H, W, log_clip)
    torch.cuda.synchronize()
    rgb, depth, T = out1
    if not all(torch.isfinite(x).all() for x in out1):
        fail(f"raster {label}: non-finite output")
    if not all(torch.equal(x, y) for x, y in zip(out1, out2)):
        fail(f"raster {label}: two launches differ")
    err_rgb = (rgb - ref[0]).abs().max().item()
    cover = 1.0 - ref[2]
    covered = cover >= 0.01
    d_k, d_p = depth / torch.clamp(1.0 - T, min=1e-6), ref[1] / torch.clamp(cover, min=1e-6)
    err_depth = ((d_k - d_p).abs() / d_p.abs().clamp(min=1e-12))[covered].max().item() if covered.any() else 0.0
    drawn = float((cover > 1e-3).float().mean())
    print(f"raster {label}: max|d rgb| {err_rgb:.3e}, max rel d depth (coverage >= 0.01) {err_depth:.3e}, "
          f"drawn {100 * drawn:.1f} %, T max|d| {(T - ref[2]).abs().max().item():.3e}")
    if err_rgb > RASTER_RGB_TOL or err_depth > RASTER_DEPTH_RTOL:
        fail(f"raster {label}: kernel and plain compositor disagree")
    return err_rgb, drawn


def phase_raster(device):
    """Raster kernel vs plain at the render shapes; returns the record at
    RenderParams() (240 x 320)."""
    from gcslam_torch.outputs import raster

    record = None
    for case_i, (P, H, W) in enumerate(RASTER_CASES):
        s, params = raster_scene(P, H, W, device, seed=11 + case_i)
        label = f"P={P} {H}x{W}"
        err, drawn = check_raster(s, H, W, params.log_clip, label)
        if drawn <= 0.2:
            fail(f"raster {label}: only {100 * drawn:.1f} % of pixels drawn")
        call = lambda: raster.composite_splats(s, H, W, params.log_clip)  # noqa: E731
        ms = time_call(call, n=50)
        dev_ms = device_ms(call, "raster_kernel")
        plain_ms = time_call(lambda: raster.composite_splats_reference(s, H, W, params.log_clip), n=2)
        pairs, box_pairs, warp_share = raster_work(s, H, W, params.log_clip)
        bound_ms, bound_by = bound(P * 11 * 4 + H * W * 5 * 4, RASTER_FLOPS_PER_PAIR * pairs, PEAK_F32_PER_S)
        print(f"raster {label}: kernel {ms * 1e3:.1f} us/call (events), device {fmt_us(dev_ms)}, "
              f"plain {plain_ms * 1e3:.1f} us/call, {pairs} pairs with w > 0, bound {bound_ms * 1e3:.3f} us "
              f"({bound_by}); {box_pairs} pairs in the tiles' clip boxes, {100 * warp_share:.1f} % of their "
              f"(warp, splat) pairs with some w > 0")
        if (H, W) == (240, 320):
            record = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                          bound_by=bound_by)
    return record


def replay(device, cfg, run, label):
    """Warm-up, then one timed run_bag over all scans; returns
    (final state, outputs, ms/scan, Sinkhorn launches, ATE)."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.models import runner
    from gcslam_torch.ops import sinkhorn

    runner.run_bag(run.batches[:N_WARMUP], cfg, device=device)
    torch.cuda.synchronize()
    sinkhorn.COUNTER.reset()
    t0 = time.perf_counter()
    state, out = runner.run_bag(run.batches, cfg, device=device)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sinkhorn.COUNTER.launches

    poses = out.pose.cpu().numpy()
    n = len(run.batches)
    if poses.shape != (n, 6) or not np.all(np.isfinite(poses)):
        fail(f"{label}: poses not finite or of wrong shape {poses.shape}")
    ate = compute_ate(poses, run.gt_poses, align="initial")
    ms_scan = 1e3 * elapsed / n
    print(f"{label}: {ms_scan:.2f} ms/scan over {n} scans (after {N_WARMUP} warm-up scans); "
          f"ATE {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg; "
          f"sinkhorn launches {launches}")
    if launches != cfg.map_icp_iters * n:
        fail(f"{label}: sinkhorn launched {launches} times, expected {cfg.map_icp_iters * n}")
    if ate["translation"]["rmse"] > GATE_ATE_TRANS_RMSE_M or ate["rotation_deg"]["rmse"] > GATE_ATE_ROT_RMSE_DEG:
        fail(f"{label} ATE gate: {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg")
    return state, out, ms_scan, launches, ate


def phase_flagship(device):
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig

    t0 = time.perf_counter()
    run = generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS), device=device)
    print(f"generated {N_SCANS} scans x {N_POINTS} points in {time.perf_counter() - t0:.1f} s")
    cfg = PipelineConfig()
    _, _, ms_scan, launches, ate = replay(device, cfg, run, "flagship path")
    return run, cfg, ms_scan, launches, ate


def phase_determinism(device, run, cfg) -> None:
    import torch
    from gcslam_torch.models import runner

    n = N_DETERMINISM
    _, o1 = runner.run_bag(run.batches[:n], cfg, device=device)
    _, o2 = runner.run_bag(run.batches[:n], cfg, device=device)
    if not torch.equal(o1.pose, o2.pose):
        fail(f"repeat runs differ: max |dpose| {(o1.pose - o2.pose).abs().max().item():.3e}")
    print(f"determinism: two {n}-scan runs give bit-equal poses")


def frontend_ms(device, cfg_syn) -> float:
    """ms per frame of the camera frontend alone (extract + base frame) on
    one rendered frame, by CUDA events."""
    import torch
    from gcslam_torch import constants as C
    from gcslam_torch.frontend import camera as cam_mod
    from gcslam_torch.frontend import synthetic as syn

    traj = syn.build_trajectory(cfg_syn)
    pos, yaw, _, _, _ = traj(1.0)
    gray, depth, rgb, R_wc, origin = syn._render_rgbd(pos, yaw, cfg_syn)
    rng = np.random.default_rng(0)
    lidar = torch.as_tensor(rng.normal(0, 3, (N_POINTS, 3)) + [0, 0, 6], device=device)
    w = torch.ones(N_POINTS, dtype=torch.float64, device=device)
    intr = cam_mod.PinholeIntrinsics(cfg_syn.cam_fx, cfg_syn.cam_fx, cfg_syn.cam_w / 2.0, cfg_syn.cam_h / 2.0)
    t = [torch.as_tensor(x, device=device) for x in (gray, depth, rgb)]

    def one():
        f = cam_mod.extract_camera_features(*t, intr, lidar, w, n_feat=C.N_FEAT)
        return cam_mod.features_to_base_frame(f, syn.T_BASE_CAM)

    return time_call(one, n=20)


def phase_camera(device):
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import association

    cfg_syn = SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS, with_camera=True)
    t0 = time.perf_counter()
    run = generate(cfg_syn, device=device)
    gen_s = time.perf_counter() - t0
    fe_ms = frontend_ms(device, cfg_syn)
    n_cam = [int(b.cam_valid.sum()) for b in run.batches]
    print(f"generated {N_SCANS} camera scans in {gen_s:.1f} s (raycasts on the host, frontend on the card: "
          f"{fe_ms:.2f} ms/frame); valid camera features per scan {min(n_cam)}-{max(n_cam)}")
    if min(n_cam) < 100:
        fail(f"camera frontend found only {min(n_cam)} features in a frame")

    # record the Sinkhorn problem shapes of the camera path
    shapes = set()
    kernel_fn = association.sinkhorn_unbalanced

    def recording(C, *args, **kwargs):
        shapes.add(tuple(C.shape))
        return kernel_fn(C, *args, **kwargs)

    association.sinkhorn_unbalanced = recording
    try:
        cfg = PipelineConfig(with_camera=True)
        state, out, ms_scan, launches, ate = replay(device, cfg, run, "camera path")
    finally:
        association.sinkhorn_unbalanced = kernel_fn
    expected = (cfg.n_surfel + cfg.n_feat, cfg.k_assoc)
    if shapes != {expected}:
        fail(f"camera path: sinkhorn problem shapes {sorted(shapes)}, expected {expected}")
    print(f"camera path: every sinkhorn problem is {expected[0]} x {expected[1]}; "
          f"frontend {fe_ms:.2f} ms/frame = {100 * fe_ms / ms_scan:.1f} % of a scan's {ms_scan:.1f} ms")
    return run, state, out, ms_scan, fe_ms, launches, ate


def phase_render(device, state, out):
    """render_atlas from the final camera pose and from the overview, twice
    each; returns (launches, [(name, covered share, ms per render)], max err)."""
    import torch
    from gcslam_torch.frontend.synthetic import T_BASE_CAM
    from gcslam_torch.ops import se3
    from gcslam_torch.outputs import raster, rendering
    from gcslam_torch.tools.view_splats import overview_pose

    params = rendering.RenderParams()
    mu, _, _, _, masses = rendering.atlas_splats(state.atlas)
    poses = {
        "final camera pose": se3.se3_compose(out.pose[-1], torch.as_tensor(T_BASE_CAM, device=device)),
        "overview": torch.as_tensor(overview_pose(mu[masses > 0].cpu().numpy()), device=device),
    }
    raster.COUNTER.reset()
    renders, results = 0, []
    for name, cam in poses.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb1, depth1 = rendering.render_atlas(state.atlas, cam, params)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        rgb2, depth2 = rendering.render_atlas(state.atlas, cam, params)
        renders += 2
        if not (torch.isfinite(rgb1).all() and torch.isfinite(depth1).all()):
            fail(f"render from {name}: non-finite output")
        if not (torch.equal(rgb1, rgb2) and torch.equal(depth1, depth2)):
            fail(f"render from {name}: repeat differs")
        covered = float((depth1 > 0).float().mean())
        results.append((name, covered, ms))
    launches = raster.COUNTER.launches
    if launches != renders:
        fail(f"render: {launches} raster launches for {renders} renders")
    max_err = 0.0
    for name, cam in poses.items():
        s = rendering.prepare_screen_splats(*[x.to(device) for x in rendering.atlas_splats(state.atlas)],
                                            cam, params)
        err, _ = check_raster(s, params.height, params.width, params.log_clip, f"render from {name}")
        max_err = max(max_err, err)
    for name, covered, ms in results:
        print(f"render from {name}: covered {100 * covered:.1f} % of pixels, {ms:.2f} ms per render "
              f"(top-4096 selection + projection + kernel)")
    if max(c for _, c, _ in results) <= 0.0:
        fail("render: no pixel covered from either vantage")
    return launches, results, max_err


def phase_viewer(state, out, run):
    from gcslam_torch.outputs import splat_export, tum
    from gcslam_torch.outputs import raster
    from gcslam_torch.tools import view_splats

    os.makedirs(OUT_DIR, exist_ok=True)
    npz = os.path.join(OUT_DIR, "splat_export.npz")
    traj = os.path.join(OUT_DIR, "trajectory.tum")
    n = splat_export.save_splat_export(npz, state.atlas)
    tum.write_tum(traj, out.stamp.cpu().numpy(), out.pose.cpu().numpy())
    before = raster.COUNTER.launches
    for sub, extra in (("views_last_pose", ["--traj", traj]), ("views_overview", [])):
        paths = view_splats.main([npz, "--out", os.path.join(OUT_DIR, sub)] + extra)
        rgb, depth = np.load(paths["render_rgb.npy"]), np.load(paths["render_depth.npy"])
        if rgb.shape != (360, 480, 3) or not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
            fail(f"viewer ({sub}): bad output {rgb.shape}")
        print(f"viewer ({sub}): {n} splats exported, covered {100 * float((depth > 0).mean()):.1f} %")
    if raster.COUNTER.launches != before + 2:
        fail("viewer: the renders did not go through the raster kernel")


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(nvidia_smi_line())

    # 2. kernels against their plain versions
    phase_build()
    sk = phase_sinkhorn(device)
    rs = phase_raster(device)

    # 3-4. the flagship path and determinism
    run, cfg, ms_flag, launches_flag, ate_flag = phase_flagship(device)
    phase_determinism(device, run, cfg)

    # 5-7. the camera path, the render of its map, the viewer
    run_cam, state_cam, out_cam, ms_cam, fe_ms, launches_cam, ate_cam = phase_camera(device)
    launches_raster, renders, err_render = phase_render(device, state_cam, out_cam)
    phase_viewer(state_cam, out_cam, run_cam)

    kernels = [
        dict(name="sinkhorn_unbalanced", route="cuda", source="gcslam_torch/csrc/sinkhorn.cu",
             replaces="gcslam_tpu/ops/sinkhorn_pallas.py:59", launches=launches_cam,
             max_abs_err=sk[1536]["max_abs_err"], ms=sk[1536]["ms"], device_ms=sk[1536]["device_ms"],
             plain_ms=sk[1536]["plain_ms"], bound_ms=sk[1536]["bound_ms"], bound_by=sk[1536]["bound_by"],
             library_ms=None),
        dict(name="render_splats_raster", route="cuda", source="gcslam_torch/csrc/raster.cu",
             replaces="gcslam_tpu/outputs/rendering_pallas.py:128", launches=launches_raster,
             max_abs_err=max(rs["max_abs_err"], err_render), ms=rs["ms"], device_ms=rs["device_ms"],
             plain_ms=rs["plain_ms"], bound_ms=rs["bound_ms"], bound_by=rs["bound_by"], library_ms=None),
    ]
    print(json.dumps({"paths": {
        "flagship": {"ms_per_scan": ms_flag, "n_scans": N_SCANS, "n_points": N_POINTS,
                     "ate_m": ate_flag["translation"]["rmse"], "ate_deg": ate_flag["rotation_deg"]["rmse"],
                     "sinkhorn_launches": launches_flag, "sinkhorn_1024": sk[1024]},
        "camera": {"ms_per_scan": ms_cam, "frontend_ms_per_frame": fe_ms, "n_scans": N_SCANS,
                   "ate_m": ate_cam["translation"]["rmse"], "ate_deg": ate_cam["rotation_deg"]["rmse"],
                   "sinkhorn_launches": launches_cam, "sinkhorn_1536": sk[1536]},
        "render": [{"vantage": n, "covered": c, "ms": ms} for n, c, ms in renders],
    }}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
