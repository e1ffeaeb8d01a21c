"""Smoke test of the PyTorch/CUDA port (gcslam_torch) on NVIDIA GPUs.

    python3 chip_smoke.py                 # every phase; one card is enough
    python3 chip_smoke.py --phases 1,2,15 # the device, the kernels and the mesh alone
    python3 chip_smoke.py --phases 1,2,18 # the device, the kernels and the compiled step alone

Phases, in order; any failure exits non-zero before the result line:
  1. device: a CUDA card is required (no CPU fallback); prints its name and
     `nvidia-smi` name + power limit;
  2. kernels: builds csrc/sinkhorn.cu, csrc/raster.cu, csrc/eigh.cu and
     csrc/se3.cu with nvcc (one process each, started together) and holds
     each kernel against its plain PyTorch version on the card at the main
     paths' shapes (the Sinkhorn at B = 1, 2, 4 and 8 problems of 1024 rows
     among them, the sweep's): Sinkhorn
     in f32 and f64 with a third of the rows at zero mass, the launcher's
     cluster size per shape (checked against ops/sinkhorn.cluster_layout),
     two launches bit-equal; the splat rasterizer at P = 4096 on 240 x 320
     and 360 x 480 (max |d rgb| <= 1e-5, relative depth error <= 1e-4 where
     coverage 1 - T >= 0.01, finite, > 20 % of pixels drawn, two launches
     bit-equal, and the (pixel, splat) pairs it composites); times both by
     CUDA events over back-to-back calls and by the kernel's own device
     time in torch.profiler; prints ptxas registers, spills and shared
     memory; eigh3, psd3 and eigh_sym on the inputs of one eager flagship
     scan (scan 3), at each instance (batch shape) it launches, in f64 and
     in f32, against their plain versions (eigenvalues and V diag(lambda)
     V^T within 1e-14 of max|lambda| in f64, 1e-6 in f32; whether
     bit-equal; psd3: M_psd, eig_min and eig_max within the same of
     max|lambda|, the two deltas of |M|, cond carried through the quotient,
     near_null_count equal, eig_min / eig_max bit-equal to the floored
     extremes of eigh3's eigenvalues), two launches bit-equal, beside
     torch.linalg.eigh's time on the same batch (events, which include its
     host sync, and device, the sum of its kernels; for psd3 the library
     reference, no single call computing the projection, beside the plain
     epilogue's 15 kernels), the chain floor (one thread running the
     dependent chain of the call's rotations: eigh3_chain_kernel on the
     batch's first matrix, eigh_sym_chain_kernel for the rotation lane's
     rounds, each held to its plain version) and the empty kernel (the
     fixed cost of a launch); a 3 x 3 domain_projection_psd runs psd3's
     kernel and no other (a trace of 20 calls); every kernel's
     device time comes from a torch.profiler trace whose window pads the
     calls with idle host time, and a kernel the trace does not hold fails
     the phase; eigh_sym at (1, 22, 22) and (4, 22, 22) f64 on random
     spectra too, since the library's time depends on the input; after the
     last phase, the same check on every other eigh
     instance a path's counted run launched (the camera frontend's, the
     sweeps' folded batches, the f32 child's, the mesh ranks'), on that
     path's first input of it; the Lie-group kernel (csrc/se3.cu, one
     launch a call of ops/se3's maps and of linalg.inv3x3) at every instance
     (op, dtype, batch shape) of an eager flagship scan, on the scan's own
     operands, in f64 and f32, against its plain version (skew and inv3x3
     bit-equal, the rest within 2e-15 (f64) / 1e-6 (f32) of the output's
     largest entry), two launches bit-equal, timed by CUDA events and by its
     device time, beside the plain version's events, kernel count and
     device time and the instance's bound; after the last phase, the same
     check on every other Lie-group instance the main paths launched (the
     map render's, the camera frontend's, the sweeps' folded batches, the
     f32 child's, the mesh ranks'), on that path's first operands of it;
     the kernels line counts the main paths' launches of each instance,
     the f32 child's and the mesh ranks' among them;
  3. flagship path: runner.run_bag over 50 synthetic scans of 8192 points
     at PipelineConfig() defaults; finite poses, ATE gate of bench.py
     (<= 0.30 m, <= 4.0 deg, initial-pose alignment), and exactly
     map_icp_iters x n_scans Sinkhorn launches (on the card every runner
     replays the compiled step: launches are counted at each replay); the
     psd3, eigh3 and eigh_sym launches a scan, and a profile of 3 replayed
     scans (device kernels and busy time a scan);
  4. determinism: two 10-scan flagship runs give bit-equal poses;
  5. camera path: generate(with_camera=True) (the native C++ corner stage,
     as the JAX generator) and run_bag at
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
     tools/view_splats on them (last pose and overview), .npy outputs;
  8. per-hypothesis path: run_bag over the flagship's 50 scans at
     PipelineConfig(map_share_extraction=False, map_gn_shared=False):
     finite poses, the ATE gate, ATE within 0.05 m of the flagship's
     (tests/test_pipeline.py:395), exactly map_icp_iters x n_scans Sinkhorn
     launches, every one on (K_HYP, 1024, 8); kernel launches per scan and
     device busy share from torch.profiler over 3 scans, beside the
     flagship's; the shared-extraction variant on 10 scans, same launch rule;
  9. live modes: run_chunked(chunk=10) over the flagship's 50 scans
     bit-equal to phase 3's run_bag (chunked ATE gate); run_stream over 10
     scans with the status and map streams (files parse, poses equal to
     run_bag's); the loitering world (60 x 1024 points, drifting odometry,
     no map) through run_chunked(chunk=8) with the loop detector: a loop
     fires, max xy error < 1.5 m; save_state / load_state of the chunked
     run's final state bit-equal on the card;
 10. filter options, 10 scans each at production budgets:
     imu_mode="evidence", odom_pose_mode="relative", k_shortlist=0,
     ot_subtract_row_min=True: finite poses, the ATE gate, exactly
     map_icp_iters x n_scans launches, each on (1024, 8);
 11. bag replay: frontend/bag_synth writes a 50-scan Kimera-schema rosbag2
     .db3 (VLP-16 clouds of 28,800 returns, IMU, odometry, 640 x 480 JPEG +
     16UC1 frames, pre-skewed clocks) and a TUM ground truth; load_bag
     decodes it through the native decoder (csrc/bag_decode.cpp, built with
     g++ beside the nvcc builds); `python -m gcslam_torch.eval.run` runs it at
     configs/gc_kimera.yaml's budgets with --no-camera (the card's host has
     no libjpeg headers; see PERF.md): every artifact exists and parses, the
     audit passes, finite poses, exactly map_icp_iters x n_scans Sinkhorn
     launches all on (n_surfel, k_assoc) = (512, 8), ATE under the
     rehearsal gate and within 0.05 m of the JAX package's on the same bag
     (the range it takes over one-ulp nudges of the LiDAR extrinsic, see
     BAG_LIDAR_X); the port's ATE at one of them; then load_bag alone
     and 5 warm-up and 45 timed scans;
 12. the canonical camera-on bag: tools/make_synth_bag with the JAX
     rehearsal's arguments (circuit, integrated odometry, 16384 raw points,
     640 x 480 JPEG + 16UC1) at 40 of its 160 scans, then the rehearsal's
     `full` variant command (eval.run --chunk 10 --loop at
     configs/gc_kimera.yaml, camera on) with --live-view: every artifact,
     the audit passes, live.jsonl holds one pose line per scan, exactly
     map_icp_iters x n_scans Sinkhorn launches all on (n_surfel + n_feat,
     k_assoc) = (1024, 8), ATE under the rehearsal gate and within 0.05 m
     of the JAX package's range on the same bag (JAX_CANON_ATE); load_bag
     with the camera and without it (the camera's share), and one
     tools/view_splats render of the result through the raster kernel;
 13. the f32-belief flagship: phase 3's replay in a child process with
     GCSLAM_BELIEF_DTYPE=float32 (the dtype binds at import): finite
     float32 poses, the ATE gate, exactly 100 launches, every one the
     kernel's f32 instance at (1024, 8); ms/scan and PRECISION_r05.json's
     certificate fields beside phase 3's f64 run;
 14. replay sweeps (parallel/sweep.py): the vmapped Sinkhorn is one launch
     for all problems, bit-equal to per-problem launches; 8 flagship runs
     (seeds 0-7, 50 scans of 8192 points) through sweep.run_sweep, with
     no op on vmap's per-sample path (its warning fails the phase): every
     run under the ATE gate, the seeds' trajectories apart, run 0's ATE
     within 1e-3 m of phase 3's run_bag (its largest pose difference and
     whether it is bit-equal recorded), exactly 2 Sinkhorn launches a
     scan, all on (8, 1024, 8); run 0 over 10 scans beside the other
     seven in reverse order bit-equal to run 0 of that sweep (no run
     depends on another); at R = 1, 2, 4 and 8, ms/scan over 10
     scans after 2, 2 launches a scan on (R, 1024, 8), and a profile
     (launch calls, device busy share; 3 scans at R = 8, one at the
     others); the per-hypothesis sweep (map_gn_shared=False) at R = 2 over
     10 scans, every launch on (2 x K_HYP, 1024, 8); two R = 2 sweeps
     bit-equal;
 15. the sweep over a device mesh (parallel/mesh.py), its ranks spawned by
     mesh.run_ranks: on one NCCL rank, the (run=1) mesh over flagship
     seeds 0-1 x 10 scans bit-equal to run_sweep at R = 2, exactly 2
     Sinkhorn launches a scan on (2, 1024, 8) and one run-axis collective a
     scan, and the sharded checkpoint (save after scan 5, restore, continue)
     bit-equal; on two gloo ranks sharing the card, where gloo's all_gather
     takes CUDA tensors, the per-hypothesis (run=1, hyp=2) and the
     (run=1, map=2) families over 5 scans against run_sweep (else a line
     says they ran only on several cards); with n >= 2 cards, one NCCL
     rank each, phase 14's 8 seeds x 50 scans on (run=n), on
     (run=n/2, hyp=2) per hypothesis and on (run=n/2, map=2): every run
     under the ATE gate and, with the shared GN chain, within 1e-3 m of
     phase 14's run (per hypothesis within 0.05 m), 2 Sinkhorn launches a
     scan on every rank, ms/scan after 2 scans and collectives per scan;
 16. the tools on the card's host (which has no JAX and no matplotlib), on
     phase 11's bag, its ground truth and its eval.run output, each through
     its main() in this process and bag_info also through `python3 -m` in a
     child: compute_time_alignment and kimera_calibration_to_gc prepare a
     copy of configs/gc_kimera.yaml (the profile, read back through the
     copy, has finite IMU and odometry offsets; the extrinsics come back
     within 1e-6), then every forensics, trajectory and map-event tool
     exits with its success code (replay_map_events' integrity checks over
     all 50 scans, trajectory_swaps ranking the identity first), and
     dead_reckon, estimate_extrinsics (within 1e-12) and
     diagnose_gyro_composition (within 1e-9, verdict OK) give the same
     report on the card as with --cpu; the phase's and each tool's seconds
     go to {"paths": {"tools": ...}}, and the phase fails past 90 s.
     Skipped with --phases 1,2,15.
 17. the measurement layer at PipelineConfig(), each tool through its
     main() or its module function in this process: tools/warm_cache
     (every library already built by phase 1, this process built none;
     the seconds to load each, one flagship step, one 10-scan chunk);
     tools/cold_start in one fresh child process (its milestones in
     increasing order, no native build before its first pose); phase 3's
     run_bag ledger (utils/profiling.COUNTERS; every replay() checks one
     host-to-device call, no read back and no host sync before the
     gather); the implicit host syncs of 3 flagship scans under
     torch.cuda.set_sync_debug_mode("warn"), with their call sites;
     tools/profile_step over 5 steps (p50/p95 ms, peak device memory, the
     first scan); tools/kernel_census of scan 5 after 5, its launch calls
     within 1 % of phase 8's flagship launch calls a scan and every launch
     attributed, the top 25 functions; tools/microbench_scatter at the
     production shapes, the strategies' checksums within 1e-3 of one
     another. Skipped with --phases 1,2,15.
 18. the compiled step (models/runner.CompiledStep) at PipelineConfig():
     a fresh capture (its seconds); 3 eager flagship scans under
     torch.cuda.set_sync_debug_mode("error") (no implicit host sync); the
     50-scan flagship through run_bag's graph replays against the eager
     step (poses and tape bit-equal), the ATE gate, exactly 100 Sinkhorn
     launches counted over the replays, the 1 / 0 / 0 ledger, the psd3,
     eigh3 and eigh_sym launches a replayed scan; scan 5 on the plain
     routes (the Sinkhorn loop, the Jacobi chains, the projection's torch
     epilogue) against the kernels within tests/test_torch_slice.py's
     tolerances; eager and graph ms/scan over 10 scans in 3 interleaved
     pairs; a torch.profiler record of 3 replays (the Sinkhorn, eigh3,
     psd3 and eigh_sym launches the counters credit over them equal to the
     kernels in its trace, and each kernel's device ms a scan) and of 3
     eager steps. With --phases 1,2,18 it runs
     alone after phases 1-2.
Before the last line it prints {"paths": ...} and {"kernels": [...]}, one
kernel record per instance the main paths launch (dtype and shape), and
fails if one was never launched; the last line is {"ok": true, "device":
{...}}. Files go to results/chip_smoke/.
"""

import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

N_SCANS = 50
N_POINTS = 8192
# features a 160 x 120 frame of the synthetic world gives the native corner
# stage, the JAX generator's route: 62-81 a frame on the CPU (the pure
# Harris route gives > 200)
MIN_CAM_FEATURES = 50
N_WARMUP = 5
N_DETERMINISM = 10
GATE_ATE_TRANS_RMSE_M = 0.30
GATE_ATE_ROT_RMSE_DEG = 4.0
SINKHORN_CASES = [(1, 1024, 8), (2, 1024, 8), (4, 1024, 8), (8, 1024, 8), (1, 1536, 8), (1, 512, 8), (1, 257, 8),
                  (1, 1, 8), (1, 2048, 8), (4, 129, 20)]
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
VIEWER_RENDERS = 2  # phase 7: from the last pose and from the overview
PER_HYP = dict(map_share_extraction=False, map_gn_shared=False)
PER_HYP_ATE_BOUND_M = 0.05  # |ATE per-hypothesis - ATE flagship|, tests/test_pipeline.py:395
N_SHARED_EXTRACTION_SCANS = 10
N_PROFILE_SCANS = 3
CHUNK = 10
GATE_CHUNK_ATE_TRANS_RMSE_M = 0.30  # bench.py
N_STREAM_SCANS = 10
LOITER = dict(n_scans=60, n_points=1024, odom_drift_pos_per_m=0.08, odom_drift_yaw_per_m=0.04, seed=0)
LOOP_CFG = dict(keyframe_every=5, min_index_gap=15, max_revisit_dist_m=3.0, cooldown_scans=10)
LOITER_MAX_XY_M = 1.5  # tests/test_pipeline.py::test_chunked_loop_closure_fires
N_OPTION_SCANS = 10  # cut from 20 to keep the script near 650 s
OPTIONS = {
    "imu_evidence": dict(imu_mode="evidence"),
    "odom_relative": dict(odom_pose_mode="relative"),
    "full_pool": dict(k_shortlist=0),
    "row_min": dict(ot_subtract_row_min=True),
}
BAG_SYNTH = dict(n_scans=50, n_points=28800, seed=0)  # VLP-16 at 10 Hz: 16 x 1800 returns a scan
BAG_POINTS = 8192  # the point budget the frontend resamples each scan to
BAG_CAM_SIZE = (640, 480)
BAG_CONFIG = os.path.join("configs", "gc_kimera.yaml")
# The replay of this bag is ill-conditioned in the JAX package itself: a
# 1e-7 m nudge of the LiDAR extrinsic moves its scan-4 pose by 3.1e-3 m and
# its trajectory by up to 0.28 m, and its ATE lands anywhere in
# 0.019-0.135 m over the three nudges below. So the
# reference is the JAX package's ATE at the config's LiDAR extrinsic and at
# three nudges of its x translation by 1e-7 or 3e-7 m (which change the
# float32 rounding of a share of the points), and the port's run is held
# within BAG_ATE_BOUND_M of that range. Measured on a CPU with the JAX
# package's own CLIs:
#   python -m gcslam_tpu.tools.make_synth_bag --out kimera_synth.db3 \
#       --gt kimera_synth_gt.tum --config configs/gc_kimera.yaml --scans 50 \
#       --points 28800 --trajectory ramp --odom-model additive --drift 0.02 --seed 0
# (the rows write_synth_bag(SyntheticConfig(**BAG_SYNTH)) writes here, the
# same bytes: tests/test_torch_bag.py), then for each x of BAG_LIDAR_X
#   python -m gcslam_tpu.eval.run --cpu --no-camera --bag kimera_synth.db3 \
#       --config configs/gc_kimera.yaml --gt kimera_synth_gt.tum --frontend-set \
#       "T_base_lidar=[x, -0.100474, 0.108987, -0.002723, -0.069383, 0.028979]"
BAG_LIDAR_X = {"config": -0.065447, "+1e-7": -0.0654469, "-1e-7": -0.0654471, "+3e-7": -0.0654467}
JAX_BAG_ATE = {  # m, deg
    "config": (0.02089121266654113, 0.4485889270515829),
    "+1e-7": (0.1346359666829979, 2.7602189851207664),
    "-1e-7": (0.018777257144953364, 0.45465630919970734),
    "+3e-7": (0.05663981843638647, 0.9072324468394252),
}
BAG_ATE_BOUND_M = 0.05  # tests/test_pipeline.py:395
# the port's own replay at the nudge where the JAX package reads highest
# (one of BAG_LIDAR_X's three, to keep the full call inside its time limit)
PORT_BAG_NUDGE = "+1e-7"
REHEARSAL_GATE = (0.38, 4.0)  # m, deg: the rehearsal's gate (REHEARSAL_r05.json)
# Phase 12: the rehearsal's canonical bag (tools/make_synth_bag with
# gcslam_tpu/tools/rehearse.py's arguments: circuit, integrated odometry,
# 16384 raw points, the 640 x 480 camera) cut from 160 to 40 scans, through
# the `full` variant's eval.run command with --live-view. The JAX package's
# ATE on the same 40-scan bag, on a CPU, with its own CLIs:
#   python -m gcslam_tpu.tools.make_synth_bag --out b40.db3 --gt b40_gt.tum \
#       --config configs/gc_kimera.yaml --scans 40 --trajectory circuit --odom-model integrated
#   python -m gcslam_tpu.eval.run --cpu --bag b40.db3 --config configs/gc_kimera.yaml \
#       --gt b40_gt.tum --chunk 10 --loop [--frontend-set "T_base_lidar=[x, y, z, -0.002723, -0.069383, 0.028979]"]
# at the config's LiDAR extrinsic and at 15 one-ulp nudges of its
# translation (x by +1e-7 to +5e-7 and -1e-7 to -4e-7 m, y by +-1e-7 and
# +2e-7 m, z by +-1e-7 and -2e-7 m): all 16 land at 0.088-0.107 m. The
# replay has a second mode: the map's first big insert (scan 5, 19 -> 144
# primitives) decides whether scan 7 onwards keeps matching the map
# (transport mass 3-23 a scan, ATE ~0.027 m) or loses it (mass ~0, odometry
# carries the pose, ATE ~0.09 m). Which one a run takes follows the last
# bits of the state after scan 5: the JAX package's own step, replaying
# scans 6-39 from the port's state after scan 5 (its pose 3.7e-5 m from the
# JAX package's, the outcome of float32 one-ulp differences at scan 3),
# takes the low mode: 0.0270 m ("port_state_6" below; `python
# tests/cross_check.py handover --bag b40.db3 --gt b40_gt.tum --scan 6`).
# The port's CPU runs read 0.0269 m at the config's extrinsic and 0.0257 /
# 0.0939 / 0.0263 m at x +1e-7 / -1e-7 / +3e-7 m. The reference range is
# all of these JAX runs.
CANON_SCANS = 40
CANON_SYNTH = ["--scans", str(CANON_SCANS), "--trajectory", "circuit", "--odom-model", "integrated"]
JAX_CANON_ATE = {  # m, deg
    "config": (0.09426250328974128, 0.5483186744585582),
    "x+1e-7": (0.09285447262983573, 0.4343431406008462),
    "x-1e-7": (0.0895535635955576, 0.621031807913694),
    "x+2e-7": (0.10110927870748093, 0.7726454137921913),
    "x-2e-7": (0.09916167495536014, 0.38760276873115673),
    "x+3e-7": (0.08909868803959582, 0.6296270019753738),
    "x-3e-7": (0.08893838191746789, 0.6165796347375612),
    "x+4e-7": (0.1066311390039374, 0.6357193646206043),
    "x-4e-7": (0.0882152093954025, 0.634223985328636),
    "x+5e-7": (0.09257306425060137, 0.4613826285102805),
    "y+1e-7": (0.08836534378940884, 0.6164680033619679),
    "y-1e-7": (0.09403278981086793, 0.5135805422365823),
    "y+2e-7": (0.09966369797500949, 0.39786839717691785),
    "z+1e-7": (0.09355350089728187, 0.5091055771749889),
    "z-1e-7": (0.0893839550518187, 0.6298740322223437),
    "z-2e-7": (0.0906827122491074, 0.6104800581212817),
    "port_state_6": (0.026998326359995283, 0.3464756778121996),
}
CANON_ATE_BOUND_M = 0.05  # tests/test_pipeline.py:395
# Phase 14: replay sweeps (parallel/sweep.py), R runs of the flagship world
# (seeds 0 to R - 1) advancing together under torch.func.vmap
SWEEP_RUNS = 8
SWEEP_R = (1, 2, 4, 8)
SWEEP_WARMUP = 2  # scans before each timed R
SWEEP_SCANS = 10  # timed scans at each R, the cross-run witness, the per-hypothesis sweep and the repeat runs
SWEEP_PROFILE_SCANS = 3  # profiled scans at R = 8 (one at the other R)
SWEEP_RUN0_ATE_BOUND_M = 1e-3  # |ATE of sweep run 0 - ATE of phase 3's run_bag|
SWEEP_SEEDS_DIFFER_M = 1e-4
# Phase 15: the sweep over a device mesh (parallel/mesh.py), ranks spawned
# by mesh.run_ranks, one NCCL rank per card
MESH_ONE_CARD_RUNS = 2  # flagship seeds 0-1 on the (run=1) mesh, bit-equal to run_sweep at R = 2
MESH_ONE_CARD_SCANS = 10
MESH_CKPT_AT = 5  # the sharded checkpoint: saved after this many scans, resumed, continued
MESH_SHARED_CARD_SCANS = 5  # the 2-D families on two gloo ranks sharing the one card
# max |d pose| of a family against run_sweep, without a mesh, of the same
# runs where the batch shapes differ (hypothesis or tile blocks); the run
# axis alone keeps every shape and is held bit-equal
MESH_POSE_BOUND_M = 1e-9
MESH_WARMUP = 2  # scans before the timed ones of each family on >= 2 cards
MESH_REF_SCANS = 10  # each rank's block of runs replayed without a mesh, held against the family's first scans
MESH_PROFILE_SCANS = 2  # profiled on every rank after each family's run (CUDA activity alone)
MESH_ATE_BOUND_M = SWEEP_RUN0_ATE_BOUND_M  # run r of a shared-GN family against phase 14's run r
MESH_TIMEOUT_S = 600
# Phase 13: the f32-belief flagship (the JAX package's production mode,
# BENCH_r05.json), in a child process with GCSLAM_BELIEF_DTYPE=float32
F32_ENV = {"GCSLAM_BELIEF_DTYPE": "float32"}
F32_EIGH_INPUTS = os.path.join(OUT_DIR, "f32_eigh_inputs.npz")
F32_LIE_INPUTS = os.path.join(OUT_DIR, "f32_lie_inputs.npz")
BAG_ARTIFACTS = ["runtime_manifest.json", "trajectory.tum", "ground_truth.tum", "diagnostics.npz",
                 "splat_export.npz", "metrics.json", "metrics.csv", "dashboard.html", "map_events.jsonl",
                 "audit.json"]
# Phase 16: the bag-preparation, forensics, trajectory and device tools
# (gcslam_torch/tools) on phase 11's bag and eval.run output, on the card's
# host (no JAX and no matplotlib there)
TOOLS_PHASE_LIMIT_S = 90.0
# phase 17 (the measurement layer)
PROFILE_STEPS = 5
# eigh3 / eigh_sym against their plain versions, relative to the batch item's
# max |lambda| (eigenvalues and the reconstruction V diag(lambda) V^T): the
# kernels do the plain versions' IEEE operations (built without
# contraction); eigh3's plain chain sends its 3 x 3 products to cuBLAS,
# which sums otherwise, so the two part by a few ulp over 18 rotations
EIGH_RTOL = {"float64": 1e-14, "float32": 1e-6}
# eigh3's FLOPs a matrix, the work the function needs (not the kernel's
# full 3 x 3 products): 18 rotations, each 26 for (c, s) with its guards
# and 18 each (2 outputs x 3 entries x 3 FLOPs) for rows p, q of A, columns
# p, q of A and columns p, q of V; then 35 for the symmetrization (6), the
# max|A| (11), the scaling (6), the rescaling (3) and the ranks (9)
EIGH3_FLOPS = 18 * (26 + 3 * 18) + 35
# psd3's FLOPs a matrix beyond eigh3's: M_sym (18), sym_delta (9 subtractions,
# 9 squares, 8 additions, a square root: 27), the floor (3), V diag(vals) (9),
# M_psd (9 entries x 5: 45), projection_delta (27), the extremes (4), cond
# (1), the count (3)
PSD3_EPILOGUE_FLOPS = 18 + 27 + 3 + 9 + 45 + 27 + 4 + 1 + 3
EIGH_REPLACES = {"eigh3": "gcslam_tpu/ops/linalg.py:160", "psd3": "gcslam_tpu/ops/linalg.py:33",
                 "eigh_sym": "gcslam_tpu/ops/linalg.py:45"}
# The eigen family: each kernel's launch counter in ops/eigh and the
# pattern of its name in a torch.profiler trace (psd3 is eigh3_kernel<T,
# kPsd = true>)
EIGEN_COUNTERS = {"eigh3": "EIGH3_COUNTER", "psd3": "PSD3_COUNTER", "eigh_sym": "EIGH_SYM_COUNTER"}
EIGEN_TRACE = {"eigh3": r"eigh3_kernel<\w+, (false|\(bool\)0)>", "psd3": r"eigh3_kernel<\w+, (true|\(bool\)1)>",
               "eigh_sym": r"eigh_sym_kernel"}
EIGH_RECORD_AFTER = 3  # phase 2 records the eigh inputs of flagship scan 3, after scans 0-2
# device_trace: idle host time inside a profiled window on either side of
# the calls, and the traces device_ms takes before it fails
DEVICE_TRACE_PAD_S = 0.02
DEVICE_TRACE_TRIES = 3
DEVICE_TRACE_LOG = []  # attempts and margins of every device_ms of this run
CHAIN_FLOOR_MS = {}  # chain floors: eigh_sym's by (dtype, n), eigh3's by (dtype, "eigh3", shape); "empty"
CHAIN_BLOCK_SEED = 0  # the chain floor's 4 x 4 block
EIGH_RANDOM_SEED = 12  # phase 2's random-spectrum eigh_sym inputs
# the Lie-group kernel (csrc/se3.cu, ops/se3.launch): outputs that pass through
# a 3 x 3 product or a reduction of the plain version (cuBLAS, torch's sums,
# norms and softmax) within these of the output's largest entry; skew and
# inv3x3 are elementwise and bit-equal (tests/test_torch_cuda.py LIE_RTOL)
LIE_RTOL = {"float64": 2e-15, "float32": 1e-6}
LIE_ELEMENTWISE = {"skew", "inv3x3"}
# operations an element, counted from csrc/se3.cu (a sin, cos, exp, atan2,
# sqrt or division counts one): a 3 x 3 product 45, a product with a
# vector 15, so3_exp 95, so3_log 110, se3_V / se3_V_inv 95
LIE_FLOPS = {"so3_exp": 95, "so3_log": 110, "se3_exp": 110, "se3_log": 315, "se3_compose": 363,
             "se3_inverse": 223, "se3_relative": 586, "skew": 3, "inv3x3": 95}
LIE_REPLACES = "gcslam_tpu/ops/se3.py, gcslam_tpu/ops/linalg.py inv3x3 (jnp, XLA-fused)"
# phase 18, the compiled step
N_SYNC_SCANS = 3  # eager flagship scans under set_sync_debug_mode("error")
N_TIMING_PAIRS = 3  # interleaved (eager, graph) timings
N_TIMED_SCANS = 10  # scans of each timing
EAGER_LAUNCH_BOUND = 14_500  # eager launch calls a flagship scan (27,132 before the eigen kernels)
ROUTE_POSE_ATOL = 1e-5  # tests/test_torch_slice.py POSE_ATOL (m / rad)
# tests/test_torch_slice.py's tape tolerances: exact fields, (rtol of the
# field's max |value|, atol) for the others, the mass-gated fields
ROUTE_EXACT = {"timestamp", "dt_sec", "cert_exact", "cert_frobenius_applied", "cert_n_triggers", "cert_triggers",
               "map_evicted_mass", "map_n_culled", "map_n_merged", "map_valid_total", "map_ins_ids",
               "map_ins_tiles", "io_n_points_valid", "io_n_imu_valid", "io_imu_coverage", "io_n_cam_valid",
               "io_loop_weight", "mismatch_directional_score", "excitation_dt_effect",
               "excitation_extrinsic_effect", "overconfidence_dt_asymmetry"}
ROUTE_DEFAULT_TOL = (1e-5, 1e-9)
ROUTE_TOL = {
    "cond_pose6": (1e-2, 0), "eigmin_pose6": (1e-2, 0), "mismatch_nll_per_ess": (1e-2, 0),
    "overconfidence_z_to_xy_ratio": (1e-2, 0), "support_ess_total": (1e-2, 0),
    "overconfidence_ess_to_excitation": (1e-2, 0), "ot_marginal_defect_a": (1e-3, 0),
    "map_fused_mass": (1e-2, 1e-3), "ot_transport_mass": (1e-2, 1e-3), "map_insert_mass": (1e-3, 1e-6),
    "map_ins_w": (1e-3, 1e-6), "map_ins_mu": (0, 1e-5), "io_point_weight_sum": (1e-6, 0),
    "ee_info_gain_pred": (1e-4, 0), "ee_info_gain_real": (1e-4, 0), "hyp_spread": (1e-4, 1e-12),
    "power_beta": (1e-6, 0), "total_trigger_magnitude": (1e-5, 0),
    "influence_psd_projection_delta": (0, 1e-9), "influence_anchor_drift_rho": (0, 1e-12),
}
ROUTE_MASS_GATED = {"total_trigger_magnitude", "support_ess_total", "overconfidence_ess_to_excitation"}
CENSUS_LAUNCH_RTOL = 0.01  # the census's launch calls of one scan against phase 8's a scan
SCATTER_CHECKSUM_TOL = 1e-3  # the JAX tool prints its checksums to 3 decimals
TOOLS_CARD_CPU_TOL = 1e-12  # dead_reckon / estimate_extrinsics: host float64 on bit-equal load_bag rows
GYRO_CARD_CPU_TOL = 1e-9  # diagnose_gyro_composition's report (deg, m, rad), rounded by the tool to 2-5 decimals
# the unrounded outputs of the evidence operators its probes call, card
# against CPU: max |card - cpu| over max(1, max |cpu|) of each array
GYRO_EVIDENCE_RTOL = 1e-12


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
    name (template arguments), registers, stack frame, spill stores, shared
    memory."""
    import re

    from gcslam_torch.ops.se3 import OPS as LIE_OPS

    out, name, frame, spill = [], None, "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"sinkhorn_kernelI([fd])Li(\d+)E", m.group(1))
            e = re.search(r"(eigh3_kernel|eigh3_chain_kernel|eigh_sym_kernel|eigh_sym_chain_kernel)I([fd])"
                          r"(?:L([ib])(\d+)E)?E", m.group(1))
            lie = re.search(r"lie_kernelI([fd])Li(\d+)E", m.group(1))
            name = (f"lie_kernel<{'float' if lie.group(1) == 'f' else 'double'}, {list(LIE_OPS)[int(lie.group(2))]}>"
                    if lie else f"sinkhorn_kernel<{'float' if t.group(1) == 'f' else 'double'}, KMAX={t.group(2)}>" if t
                    else (f"{e.group(1)}<{'float' if e.group(2) == 'f' else 'double'}"
                          + ("" if e.group(3) is None else f", psd={e.group(4) == '1'}" if e.group(3) == "b"
                             else f", n={e.group(4) if e.group(4) != '0' else 'any'}")
                          + ">") if e
                    else "raster_kernel" if "raster_kernel" in m.group(1)
                    else "empty_kernel" if "empty_kernel" in m.group(1) else m.group(1))
        elif "spill stores" in line:
            frame, spill = (x.strip() for x in line.strip().split(",")[:2])
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {frame}, {spill}, {smem.group(1) if smem else 0} bytes smem")
            name = None
    return out


def device_trace(fn, n: int, pad_s: float = DEVICE_TRACE_PAD_S):
    """The device activity of n calls of fn in a torch.profiler trace (its
    raw events, as utils/cuda_profile reads them), and the host clock's
    margins in ms between the calls and the trace's first and last device
    events. The window holds pad_s of idle host time before the calls and
    after their synchronize: the profiler keeps only device events whose
    timestamps, converted to the host's clock, fall inside its window, so a
    window that ends as the last kernel ends can lose them to an offset
    between the two clocks (check_eigh traces each instance without the pad
    too, and records what that trace held)."""
    import torch
    from gcslam_torch.utils import cuda_profile

    fn()
    torch.cuda.synchronize()
    marks = {}

    def calls():
        time.sleep(pad_s)
        marks["start"] = time.time_ns()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        marks["end"] = time.time_ns()
        time.sleep(pad_s)

    prof, _ = cuda_profile.profile(calls)
    events = cuda_profile.device_activity(cuda_profile.raw_events(prof))
    margins = None
    if events:
        margins = ((min(e.start_ns() for e in events) - marks["start"]) / 1e6,
                   (marks["end"] - max(e.start_ns() + e.duration_ns() for e in events)) / 1e6)
    return events, margins


def device_ms(fn, kernel: str, n: int = 20, label: str = None):
    """The kernel's own device time per launch (ms): the mean over its
    launches (the trace's kernels whose name matches the pattern `kernel`)
    in device_trace of n calls, traced again up to
    DEVICE_TRACE_TRIES times while the trace holds none of them; fails
    with the instance's label if none does."""
    for attempt in range(DEVICE_TRACE_TRIES):
        events, margins = device_trace(fn, n)
        mine = [e for e in events if re.search(kernel, e.name())]
        if mine:
            DEVICE_TRACE_LOG.append(dict(label=label or kernel, attempts=attempt + 1, events=len(mine),
                                         margins_ms=margins, name=mine[0].name()))
            return sum(e.duration_ns() for e in mine) / len(mine) / 1e6
        print(f"device trace of {label or kernel}: {len(events)} device events, none of {kernel} "
              f"(attempt {attempt + 1} of {DEVICE_TRACE_TRIES}); names: {sorted({e.name() for e in events})[:8]}",
              flush=True)
    fail(f"{label or kernel}: no {kernel} in {DEVICE_TRACE_TRIES} device traces of {n} calls")


def library_device_ms(fn, n: int, label: str) -> float:
    """The device time per call of a library call (ms): the sum of the
    kernels (copies and sets left out) in device_trace of n calls, traced
    again up to DEVICE_TRACE_TRIES times while the trace holds none."""
    from gcslam_torch.utils import cuda_profile

    for _ in range(DEVICE_TRACE_TRIES):
        events, _ = device_trace(fn, n)
        kernels = [e for e in events if not e.name().startswith(cuda_profile.NOT_KERNELS)]
        if kernels:
            return sum(e.duration_ns() for e in kernels) / n / 1e6
    fail(f"{label}: no kernel in {DEVICE_TRACE_TRIES} device traces of {n} calls")


def fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    """The kernels' nvcc builds and the bag decoder's g++ build at once."""
    from gcslam_torch.frontend import native
    from gcslam_torch.ops import eigh, se3, sinkhorn
    from gcslam_torch.outputs import raster

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        paths = list(pool.map(lambda m: m.build(), (sinkhorn, raster, eigh, se3, native)))
    print(f"built {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    for mod in (sinkhorn, raster, eigh, se3):
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


MAIN_SINKHORN = {  # the main paths' instances: (dtype, B, N) -> the phases that launch it
    ("float64", 1, 1024): "flagship, live modes, options, canonical camera-on bag (512 surfels + 512 features), "
                          "sweep R = 1",
    ("float64", 2, 1024): "sweep R = 2 (shared GN: one problem a run); mesh (run=1) at R = 2; "
                          "(run=1, map=2) on a shared card; four cards: (run=4) at R = 8",
    ("float64", 4, 1024): "per hypothesis; sweep R = 4; mesh (run=1, hyp=2) on a shared card (2 runs x 2 "
                          "hypotheses); four cards: (run=2, map=2) at R = 8",
    ("float64", 8, 1024): "sweep R = 8; per-hypothesis sweep R = 2 (2 runs x K_HYP); four cards: (run=2, hyp=2) "
                          "per hypothesis (4 runs x 2 hypotheses)",
    ("float64", 1, 1536): "camera path",
    ("float64", 1, 512): "bag replay, camera off",
    ("float32", 1, 1024): "f32-belief flagship",
}


def phase_sinkhorn(device):
    """Sinkhorn kernel vs plain on the card; returns the records of the
    main paths' instances (MAIN_SINKHORN), keyed by (dtype, B, N)."""
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
            dev_ms = device_ms(call, "sinkhorn_kernel", label=f"sinkhorn {name} {(B, N, K)}")
            peak = PEAK_F64_PER_S if dtype == torch.float64 else PEAK_F32_PER_S
            bound_ms, bound_by = sinkhorn_bound(B, N, K, n_iters, C.element_size(), peak)
            print(f"sinkhorn {name} B={B} N={N} K={K}: cluster {cl} x {threads} threads, max|err| {err:.3e}, "
                  f"kernel {ms * 1e3:.1f} us/call (events), device {fmt_us(dev_ms)}, plain {plain_ms * 1e3:.1f} "
                  f"us/call, bound {bound_ms * 1e3:.3f} us ({bound_by})")
            if (name, B, N) in MAIN_SINKHORN:
                per_iter_us = None if dev_ms is None else 1e3 * dev_ms / n_iters
                records[(name, B, N)] = dict(shape=[B, N, K], ms=ms, device_ms=dev_ms, per_iter_us=per_iter_us,
                                             cluster=cl, threads=threads, plain_ms=plain_ms, max_abs_err=err,
                                             bound_ms=bound_ms, bound_by=bound_by)
    return records


def eigh_sym_flops(n: int) -> int:
    """eigh_sym's FLOPs a matrix: per round of a sweep, n'/2 rotations of
    ~20 and the row and column passes (6 FLOPs per entry of rows p, q of A,
    of columns p, q of A and of V); and the symmetrization and scaling."""
    from gcslam_torch.ops import eigh

    players = n + (n & 1)
    return eigh.EIGH_SYM_SWEEPS * (players - 1) * (players // 2) * (20 + 18 * n) + 3 * n * n


def eigen_counters() -> dict:
    """The eigen family's launch counters by kernel name."""
    from gcslam_torch.ops import eigh

    return {name: getattr(eigh, attr) for name, attr in EIGEN_COUNTERS.items()}


def eigh_key(counter, M) -> tuple:
    """(kernel, dtype, batch shape (B, n, n)) of an eigen-family launch on M."""
    n = M.shape[-1]
    name = next(k for k, c in eigen_counters().items() if c is counter)
    return (name, str(M.dtype).replace("torch.", ""), (int(M.numel() // (n * n)), n, n))


class EighInputs:
    """While installed, the first input of every eigen-family kernel
    instance (eigh_key) launched outside a CUDA graph capture, cloned (and
    for psd3 its eps_psd), and the launches of each; an instance launched
    under a capture, where the inputs hold no values yet, goes to
    `captured`."""

    def __init__(self):
        self.inputs, self.launches, self.captured, self.eps = {}, collections.Counter(), set(), {}
        self._launch = None

    def install(self) -> "EighInputs":
        import torch
        from gcslam_torch.ops import eigh

        if self._launch is not None:
            return self
        self._launch = launch = eigh._launch

        def recording(fn, counter, M, *args, **kw):
            key = eigh_key(counter, M)
            if torch.cuda.is_current_stream_capturing():
                self.captured.add(key)
            else:
                if key not in self.inputs:
                    self.inputs[key] = M.reshape(key[2]).clone()
                    if key[0] == "psd3":
                        self.eps[key] = float(args[0])
                self.launches[key] += 1
            return launch(fn, counter, M, *args, **kw)

        eigh._launch = recording
        return self

    def uninstall(self) -> None:
        from gcslam_torch.ops import eigh

        if self._launch is not None:
            eigh._launch, self._launch = self._launch, None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def host(self) -> dict:
        """The inputs as numpy arrays keyed "kernel|dtype|BxNxN" (and
        "|eps" for psd3's eps_psd), to cross a process boundary."""
        out = {f"{k[0]}|{k[1]}|{'x'.join(map(str, k[2]))}": v.cpu().numpy() for k, v in self.inputs.items()}
        out.update({f"{k[0]}|{k[1]}|{'x'.join(map(str, k[2]))}|eps": np.array(e) for k, e in self.eps.items()})
        return out

    def merge(self, host: dict, device) -> None:
        """Add the inputs of another process (host()) that this one lacks."""
        import torch

        for name, arr in host.items():
            kernel, dt, shape = name.split("|")[:3]
            key = (kernel, dt, tuple(int(x) for x in shape.split("x")))
            if name.endswith("|eps"):
                self.eps.setdefault(key, float(arr))
            else:
                self.inputs.setdefault(key, torch.as_tensor(arr, device=device))


# The eigh launches of the main paths by instance (eigh_key), each path's
# run credited as the Sinkhorn's is (the counters set to 0 just before the
# run and read just after), with the paths that made them; EIGH_SEEN holds
# the first input of every instance the paths launched, which
# phase_eigh_paths holds against the plain version.
EIGH_LAUNCHES = collections.Counter()
EIGH_PATHS = {}
EIGH_SEEN = EighInputs()


def eigh_counts() -> dict:
    """The eigen counters' launches by instance (eigh_key)."""
    return {(name,) + k: v for name, counter in eigen_counters().items() for k, v in counter.by_instance.items()}


def eigh_reset() -> None:
    for counter in eigen_counters().values():
        counter.reset()


def eigh_credit(label: str, counts=None) -> None:
    """Add a path's eigh launches (default: the counters') to EIGH_LAUNCHES."""
    for key, n in (eigh_counts() if counts is None else counts).items():
        EIGH_LAUNCHES[key] += n
        if label not in EIGH_PATHS.setdefault(key, []):
            EIGH_PATHS[key].append(label)


@contextlib.contextmanager
def eigh_counted(label: str):
    """The eigh counters at 0 on entry, credited to `label` on exit."""
    eigh_reset()
    yield
    eigh_credit(label)


def eigh_inputs(device):
    """The inputs of the eigen kernels' launches in one eager flagship scan
    (scan EIGH_RECORD_AFTER), by instance (eigh_key): an EighInputs with the
    first input of each (psd3's eps_psd too) and its launches in the scan."""
    import torch
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_step import init_state, scan_step

    cfg = PipelineConfig()
    run = generate(SyntheticConfig(n_scans=EIGH_RECORD_AFTER + 1, n_points=N_POINTS), device=device)
    with torch.no_grad():
        state = init_state(cfg, device=device)
        for b in run.batches[:EIGH_RECORD_AFTER]:
            state, _ = scan_step(state, b, cfg)
        with EighInputs() as rec:
            scan_step(state, run.batches[EIGH_RECORD_AFTER], cfg)
    return rec


def eigh_errors(lam, V, lam_p, V_p):
    """max over the batch of |d lambda| and of |d (V diag(lambda) V^T)|,
    relative to the item's max |lambda| of the plain version."""
    import torch

    scale = lam_p.abs().amax(-1, keepdim=True).clamp(min=torch.finfo(lam.dtype).tiny)
    rec = (V * lam[..., None, :]) @ V.transpose(-1, -2)
    rec_p = (V_p * lam_p[..., None, :]) @ V_p.transpose(-1, -2)
    return (float(((lam - lam_p).abs() / scale).max()),
            float(((rec - rec_p).abs().amax((-2, -1)) / scale[..., 0]).max()))


def chain_floor_ms(M) -> float:
    """eigh_sym's latency floor on the card for M's dtype and n (ms): one
    thread runs ops/eigh.sym_rounds(n) dependent rounds of the rotation
    lane's chain (eigh_sym_chain_kernel) on a fixed 4 x 4 symmetric block of
    O(1) entries (CHAIN_BLOCK_SEED), whose rotations never fall below the
    kernel's `small` guard: the chain of a lane that rotates in every round,
    as some lane of the rotation warp does in nearly every round. Its
    (c, s) must equal the plain version's."""
    import numpy as np
    import torch
    from gcslam_torch.ops import eigh

    n, dt = M.shape[-1], str(M.dtype).replace("torch.", "")
    key = (dt, n)
    if key not in CHAIN_FLOOR_MS:
        A = np.random.default_rng(CHAIN_BLOCK_SEED).uniform(-1.0, 1.0, (4, 4))
        blk = torch.as_tensor(0.5 * (A + A.T), dtype=M.dtype, device=M.device)
        rounds = eigh.sym_rounds(n)
        got, want = eigh.sym_chain(blk, rounds), eigh.sym_chain_reference(blk, rounds)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.isfinite(got).all()):
            fail(f"eigh_sym chain {dt} n={n}: {got.tolist()} against the plain version's {want.tolist()}")
        CHAIN_FLOOR_MS[key] = device_ms(lambda: eigh.sym_chain(blk, rounds), "eigh_sym_chain_kernel",
                                        label=f"eigh_sym chain {dt} n={n}")
    return CHAIN_FLOOR_MS[key]


def eigh3_floor_ms(M, name: str = "eigh3") -> float:
    """eigh3's latency floor on the card for the batch M of instance `name`
    (ms): one thread runs the dependent chain of its 18 rotations
    (eigh3_chain_kernel) on M's first matrix, whose rotations fall below
    the `small` guard where the path's do. The chain's diagonal must equal
    the plain version's."""
    import torch
    from gcslam_torch.ops import eigh

    M0 = M.reshape(-1, 3, 3)[0].contiguous()
    key = (str(M.dtype).replace("torch.", ""), name, tuple(M.shape))
    if key not in CHAIN_FLOOR_MS:
        got, want = eigh.eigh3_chain(M0), eigh.eigh3_chain_reference(M0)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"eigh3 chain {key}: {got.tolist()} against the plain version's {want.tolist()}")
        CHAIN_FLOOR_MS[key] = device_ms(lambda: eigh.eigh3_chain(M0), "eigh3_chain_kernel",
                                        label=f"eigh3 chain {key[0]} {key[2]}")
    return CHAIN_FLOOR_MS[key]


def empty_kernel_ms(device) -> float:
    """The device time of csrc/eigh.cu's empty kernel (one thread that does
    nothing), in the same padded trace as the kernels: the fixed cost of a
    launch of the library (ms), measured once a run."""
    from gcslam_torch.ops import eigh

    if "empty" not in CHAIN_FLOOR_MS:
        CHAIN_FLOOR_MS["empty"] = device_ms(lambda: eigh.empty_launch(device), "empty_kernel",
                                            label="empty kernel")
    return CHAIN_FLOOR_MS["empty"]


def check_eigh(name: str, M, inputs: str = ""):
    """eigh3 or eigh_sym on the batch M against its plain version: finite,
    two launches bit-equal, within EIGH_RTOL; times the kernel (events and
    device), its plain version and torch.linalg.eigh on M (events, which
    include its host sync, and device, the sum of its kernels), and for
    eigh_sym the chain floor; records how many of 20 launches a trace
    without device_trace's pad holds; returns the instance's record.
    `inputs` names inputs other than a path's in the printed label."""
    import torch
    from gcslam_torch.ops import eigh

    kernel = eigh.eigh3 if name == "eigh3" else eigh.eigh_sym
    plain = eigh.eigh3_reference if name == "eigh3" else eigh.eigh_sym_reference
    pattern = EIGEN_TRACE[name]
    dt, shape = str(M.dtype).replace("torch.", ""), tuple(M.shape)
    label = f"{name} {dt} {shape}" + (f" ({inputs})" if inputs else "")
    lam, V = kernel(M)
    lam2, V2 = kernel(M)
    lam_p, V_p = plain(M)
    torch.cuda.synchronize()
    if not (torch.isfinite(lam).all() and torch.isfinite(V).all()):
        fail(f"{label}: non-finite output")
    if not (torch.equal(lam, lam2) and torch.equal(V, V2)):
        fail(f"{label}: two launches differ")
    err_lam, err_rec = eigh_errors(lam, V, lam_p, V_p)
    exact = torch.equal(lam, lam_p) and torch.equal(V, V_p)
    if max(err_lam, err_rec) > EIGH_RTOL[dt]:
        fail(f"{label}: kernel and plain version apart by {err_lam:.3e} (eigenvalues), "
             f"{err_rec:.3e} (reconstruction) of max|lambda|, tolerance {EIGH_RTOL[dt]}")
    ms = time_call(lambda: kernel(M))
    dev_ms = device_ms(lambda: kernel(M), pattern, label=label)
    unpadded, _ = device_trace(lambda: kernel(M), 20, pad_s=0.0)
    unpadded_found = sum(1 for e in unpadded if re.search(pattern, e.name()))
    plain_ms = time_call(lambda: plain(M), n=2 if name == "eigh_sym" else 5)
    library_ms = time_call(lambda: torch.linalg.eigh(M), n=10)
    library_dev_ms = library_device_ms(lambda: torch.linalg.eigh(M), 10, f"torch.linalg.eigh {dt} {shape}")
    floor_ms = chain_floor_ms(M) if name == "eigh_sym" else eigh3_floor_ms(M)
    empty_ms = empty_kernel_ms(M.device)
    B, n = shape[0], shape[-1]
    flops = B * (EIGH3_FLOPS if name == "eigh3" else eigh_sym_flops(n))
    bound_ms, bound_by = bound(M.element_size() * B * (2 * n * n + n), flops,
                               PEAK_F64_PER_S if M.dtype == torch.float64 else PEAK_F32_PER_S)
    print(f"{label}: max |d lambda| {err_lam:.3e}, |d V L V^T| {err_rec:.3e} of max|lambda| "
          f"({'bit-equal' if exact else 'not bit-equal'} to the plain version); kernel {ms * 1e3:.1f} "
          f"us/call (events), device {fmt_us(dev_ms)}"
          + f", chain floor {fmt_us(floor_ms)}, empty kernel {fmt_us(empty_ms)}"
          + f", plain {plain_ms * 1e3:.1f} us/call, torch.linalg.eigh {library_ms * 1e3:.1f} us/call (events, "
          f"with its sync) / {fmt_us(library_dev_ms)} (device), bound {bound_ms * 1e3:.4f} us ({bound_by}); "
          f"an unpadded trace held {unpadded_found} of 20 launches")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_dev_ms,
                chain_floor_ms=floor_ms, empty_kernel_ms=empty_ms, max_abs_err=float((lam - lam_p).abs().max()), rel_err=max(err_lam, err_rec),
                bit_equal=exact, bound_ms=bound_ms, bound_by=bound_by, unpadded_trace_found=unpadded_found)


def psd3_errors(got, want, lam, M):
    """psd3's output (M_psd, cert) against its plain version's: max over the
    batch of |d M_psd| and |d eig_min|, |d eig_max| over the item's
    max|lambda| (lam: the eigenvalues of sym(M)), of |d sym_delta| and
    |d projection_delta| over |M|, and of |d cond| over the bound carried
    through the quotient (cond max|lambda| (1 / eig_max + 1 / eig_min));
    and the items whose near_null_count differs."""
    import torch

    (P, c), (P_p, c_p) = got, want
    tiny = torch.finfo(M.dtype).tiny
    scale = lam.abs().amax(-1).clamp(min=tiny)
    norm = torch.linalg.matrix_norm(M).clamp(min=tiny)
    cond_scale = c_p[..., 4].abs() * scale * (1.0 / c_p[..., 3] + 1.0 / c_p[..., 2])

    def rel(d, s):
        return float((d / s).max()) if d.numel() else 0.0

    return dict(M_psd=rel((P - P_p).abs().amax((-2, -1)), scale),
                deltas=rel((c[..., :2] - c_p[..., :2]).abs().amax(-1), norm),
                extremes=rel((c[..., 2:4] - c_p[..., 2:4]).abs().amax(-1), scale),
                cond=rel((c[..., 4] - c_p[..., 4]).abs(), cond_scale.clamp(min=tiny)),
                near_null_differ=int((c[..., 5] != c_p[..., 5]).sum()))


def check_psd3(M, eps, inputs: str = ""):
    """psd3 (the fused 3 x 3 PSD projection) on the batch M against its
    plain version (psd_parts through eigh3_reference): finite, two launches
    bit-equal; M_psd, eig_min and eig_max within EIGH_RTOL of the item's
    max|lambda|, the two deltas within EIGH_RTOL of |M| (the kernel's sums
    replace cuBLAS's bmm and torch's reductions), cond within the same
    carried through the quotient, near_null_count equal; its eig_min /
    eig_max bit-equal to the floored extremes of eigh3's eigenvalues of
    sym(M); times the kernel
    (events and device), the plain version, the plain epilogue's 15 kernels
    alone (device), eigh3 on sym(M) (device), the chain floor, the empty
    kernel and torch.linalg.eigh of sym(M) (the library reference: no
    single PyTorch call computes the projection); returns the record."""
    import torch
    from gcslam_torch.ops import eigh, linalg
    from gcslam_torch.utils import cuda_profile

    dt, shape = str(M.dtype).replace("torch.", ""), tuple(M.shape)
    label = f"psd3 {dt} {shape}" + (f" ({inputs})" if inputs else "")
    got = eigh.psd3(M, eps)
    got2 = eigh.psd3(M, eps)
    want = eigh.psd3_reference(M, eps)
    M_sym = linalg.sym(M)
    lam, V = eigh.eigh3(M_sym)
    vals = torch.clamp(lam, min=eps)
    torch.cuda.synchronize()
    if not (torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()):
        fail(f"{label}: non-finite output")
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        fail(f"{label}: two launches differ")
    if not (torch.equal(got[1][..., 2], vals.amin(-1)) and torch.equal(got[1][..., 3], vals.amax(-1))):
        fail(f"{label}: eig_min / eig_max not the floored extremes of eigh3's eigenvalues")
    err = psd3_errors(got, want, lam, M)
    tol = EIGH_RTOL[dt]
    if max(err["M_psd"], err["deltas"], err["extremes"], err["cond"]) > tol or err["near_null_differ"]:
        fail(f"{label}: kernel and plain version apart: {err} (tolerance {tol})")
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    pattern = EIGEN_TRACE["psd3"]
    ms = time_call(lambda: eigh.psd3(M, eps))
    dev_ms = device_ms(lambda: eigh.psd3(M, eps), pattern, label=label)
    traced_name = DEVICE_TRACE_LOG[-1]["name"]
    eigh3_dev_ms = device_ms(lambda: eigh.eigh3(M_sym), EIGEN_TRACE["eigh3"], label=f"eigh3 {dt} {shape} (sym(M))")
    epilogue = lambda: eigh.psd_parts(M, eps, lambda _: (lam, V))  # noqa: E731
    for _ in range(DEVICE_TRACE_TRIES):  # a blank session holds no kernel: trace again
        epi_events, _ = device_trace(epilogue, 1)
        epi_kernels = sum(1 for e in epi_events if not e.name().startswith(cuda_profile.NOT_KERNELS))
        if epi_kernels:
            break
    epi_dev_ms = library_device_ms(epilogue, 10, f"psd3 plain epilogue {dt} {shape}")
    plain_ms = time_call(lambda: eigh.psd3_reference(M, eps), n=5)
    library_ms = time_call(lambda: torch.linalg.eigh(M_sym), n=10)
    library_dev_ms = library_device_ms(lambda: torch.linalg.eigh(M_sym), 10, f"torch.linalg.eigh {dt} {shape}")
    floor_ms = eigh3_floor_ms(M_sym, "psd3")
    empty_ms = empty_kernel_ms(M.device)
    B = shape[0]
    bound_ms, bound_by = bound(M.element_size() * B * (9 + 9 + 6), B * (EIGH3_FLOPS + PSD3_EPILOGUE_FLOPS),
                               PEAK_F64_PER_S if M.dtype == torch.float64 else PEAK_F32_PER_S)
    print(f"{label}: |d M_psd| {err['M_psd']:.3e}, |d eig_min|, |d eig_max| {err['extremes']:.3e} of max|lambda|; "
          f"|d deltas| {err['deltas']:.3e} of |M|; |d cond| {err['cond']:.3e} of its bound; near_null_count equal "
          f"({'bit-equal' if exact else 'not bit-equal'} to the plain version); kernel {ms * 1e3:.1f} us/call "
          f"(events), device {fmt_us(dev_ms)} (eigh3 on sym(M) {fmt_us(eigh3_dev_ms)}), chain floor "
          f"{fmt_us(floor_ms)}, empty kernel {fmt_us(empty_ms)}, plain {plain_ms * 1e3:.1f} us/call, plain epilogue "
          f"{epi_kernels} kernels, {fmt_us(epi_dev_ms)} (device); torch.linalg.eigh {library_ms * 1e3:.1f} us/call "
          f"(events) / {fmt_us(library_dev_ms)} (device); bound {bound_ms * 1e3:.4f} us ({bound_by}); traced as "
          f"{traced_name!r}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None, eigh_library_ms=library_ms,
                library_device_ms=library_dev_ms, eigh3_device_ms=eigh3_dev_ms, epilogue_kernels=epi_kernels,
                epilogue_device_ms=epi_dev_ms, chain_floor_ms=floor_ms, empty_kernel_ms=empty_ms,
                max_abs_err=float((got[0] - want[0]).abs().max()), rel_err=max(err["M_psd"], err["deltas"],
                                                                                err["extremes"], err["cond"]),
                bit_equal=exact, bound_ms=bound_ms, bound_by=bound_by, unpadded_trace_found=None)


def check_projection_kernels(M, eps) -> int:
    """linalg.domain_projection_psd of the (B, 3, 3) batch M on the card
    runs psd3's kernel and no other: every kernel in a device trace of 20
    calls is psd3's (up to DEVICE_TRACE_TRIES padded sessions while one
    holds no kernel); returns how many the trace held."""
    from gcslam_torch.ops import linalg
    from gcslam_torch.utils import cuda_profile

    label = f"domain_projection_psd {str(M.dtype).replace('torch.', '')} {tuple(M.shape)}"
    for _ in range(DEVICE_TRACE_TRIES):
        events, _ = device_trace(lambda: linalg.domain_projection_psd(M, eps), 20)
        kernels = [e.name() for e in events if not e.name().startswith(cuda_profile.NOT_KERNELS)]
        if kernels:
            break
    others = sorted({k for k in kernels if not re.search(EIGEN_TRACE["psd3"], k)})
    if not kernels or others or len(kernels) > 20:
        fail(f"{label}: 20 calls ran {len(kernels)} kernels, not psd3's: {others}")
    print(f"{label}: 20 calls, {len(kernels)} kernels in the trace, all psd3's")
    return len(kernels)


def check_eigen(key, M, eps=None, inputs: str = ""):
    """check_psd3 or check_eigh of the instance `key` on M."""
    return check_psd3(M, eps, inputs) if key[0] == "psd3" else check_eigh(key[0], M, inputs)


class LieInputs:
    """While installed, the first operands (and eps) of every instance of
    the Lie-group kernel (op, dtype, batch shape) launched outside a CUDA
    graph capture, cloned as the call passed them (before the broadcast),
    and the launches of each; an instance launched under a capture, where
    the operands hold no values yet, goes to `captured`. It wraps
    ops/se3.launch, which every launch of gcslam::lie and gcslam::inv3x3
    goes through, a vmapped call's with the vmapped dims folded in."""

    def __init__(self):
        self.inputs, self.launches, self.captured = {}, collections.Counter(), set()
        self._launch = None

    def install(self) -> "LieInputs":
        import torch
        from gcslam_torch.ops import se3

        if self._launch is not None:
            return self
        self._launch = launch = se3.launch

        def recording(op, a, b=None, eps=0.0):
            key = (op, str(a.dtype).replace("torch.", ""), se3.batch_shape(op, a, b))
            if torch.cuda.is_current_stream_capturing():
                self.captured.add(key)
            else:
                if key not in self.inputs:
                    self.inputs[key] = (a.clone(), None if b is None else b.clone(), eps)
                self.launches[key] += 1
            return launch(op, a, b, eps)

        se3.launch = recording
        return self

    def uninstall(self) -> None:
        from gcslam_torch.ops import se3

        if self._launch is not None:
            se3.launch, self._launch = self._launch, None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def host(self) -> dict:
        """The operands as numpy arrays keyed "op|dtype|BxN|a" (and "|b",
        "|eps"), to cross a process boundary."""
        out = {}
        for (op, dt, batch), (a, b, eps) in self.inputs.items():
            name = f"{op}|{dt}|{'x'.join(map(str, batch))}"
            out[f"{name}|a"], out[f"{name}|eps"] = a.cpu().numpy(), np.array(eps)
            if b is not None:
                out[f"{name}|b"] = b.cpu().numpy()
        return out

    def merge(self, host: dict, device) -> None:
        """Add the operands of another process (host()) that this one lacks."""
        import torch

        parts = collections.defaultdict(dict)
        for name, arr in host.items():
            op, dt, shape, part = name.split("|")
            parts[(op, dt, tuple(int(x) for x in shape.split("x") if x))][part] = arr
        for key, p in parts.items():
            if key not in self.inputs:
                b = torch.as_tensor(p["b"], device=device) if "b" in p else None
                self.inputs[key] = (torch.as_tensor(p["a"], device=device), b, float(p["eps"]))


# The Lie-group kernel's launches of the main paths by instance (op, dtype,
# batch shape) in other processes (the f32 child's, the mesh ranks'); this
# process's are LIE_COUNTER's from phase 2's end. LIE_SEEN holds the first
# operands of every instance the paths launched, which phase_lie_paths
# holds against the plain version; LIE_FIRST the phase that first launched
# each (lap()).
LIE_LAUNCHES = collections.Counter()
LIE_SEEN = LieInputs()
LIE_FIRST = {}


def lie_counts() -> dict:
    """LIE_COUNTER's launches by instance (op, dtype, batch shape)."""
    from gcslam_torch.ops import se3

    return {(shape[0], dt, shape[1:]): n for (dt, shape), n in se3.LIE_COUNTER.by_instance.items()}


def lie_call(op, a, b=None, eps=0.0, plain=False):
    """The public function of a Lie-group kernel op (linalg.inv3x3 for
    inv3x3), or its plain version."""
    from gcslam_torch.ops import linalg, se3

    if op == "inv3x3":
        return (linalg.inv3x3_reference if plain else linalg.inv3x3)(a, eps)
    return (se3.lie_reference if plain else se3.lie)(op, a, b)


def lie_inputs(device) -> LieInputs:
    """The Lie-group launches of one eager flagship scan (scan
    EIGH_RECORD_AFTER), by instance: the first operands of each and its
    launches in the scan."""
    import torch
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_step import init_state, scan_step

    cfg = PipelineConfig()
    run = generate(SyntheticConfig(n_scans=EIGH_RECORD_AFTER + 1, n_points=N_POINTS), device=device)
    with torch.no_grad():
        state = init_state(cfg, device=device)
        for b in run.batches[:EIGH_RECORD_AFTER]:
            state, _ = scan_step(state, b, cfg)
        with LieInputs() as rec:
            scan_step(state, run.batches[EIGH_RECORD_AFTER], cfg)
    return rec


def check_lie(key, a, b, eps, inputs: str) -> dict:
    """The Lie-group kernel's instance `key` on the operands a (and b)
    against the plain version on the card: finite, two launches bit-equal,
    bit-equal (skew, inv3x3) or within LIE_RTOL of the output's largest
    entry; times the kernel (events and device), the plain version (events,
    and the device time and kernel count of one call's chain); returns the
    record, `inputs` naming the operands."""
    import torch
    from gcslam_torch.ops import se3
    from gcslam_torch.utils import cuda_profile

    op, dt, batch = key
    label = f"lie {op} {dt} {batch}"
    kernel = lambda: lie_call(op, a, b, eps)  # noqa: E731
    plain = lambda: lie_call(op, a, b, eps, plain=True)  # noqa: E731
    before = se3.LIE_COUNTER.launches
    got, got2, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if se3.LIE_COUNTER.launches != before + 2:
        fail(f"{label}: {se3.LIE_COUNTER.launches - before} launches for 2 calls")
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    if not torch.equal(got, got2):
        fail(f"{label}: two launches differ")
    exact = torch.equal(got, want)
    rel = float((got - want).abs().max() / want.abs().max().clamp(min=torch.finfo(got.dtype).tiny))
    if (op in LIE_ELEMENTWISE and not exact) or rel > LIE_RTOL[dt]:
        fail(f"{label} ({inputs}): kernel and plain version apart by {rel:.3e} of the output's largest entry "
             f"(tolerance {0.0 if op in LIE_ELEMENTWISE else LIE_RTOL[dt]})")
    ms = time_call(kernel)
    dev_ms = device_ms(kernel, r"lie_kernel", label=label)
    plain_ms = time_call(plain, n=10)
    for _ in range(DEVICE_TRACE_TRIES):  # a blank session holds no kernel: trace again
        events, _ = device_trace(plain, 1)
        plain_kernels = sum(1 for e in events if not e.name().startswith(cuda_profile.NOT_KERNELS))
        if plain_kernels:
            break
    plain_dev_ms = library_device_ms(plain, 10, f"plain {op} {dt} {batch}")
    n = max(math.prod(batch), 1)
    n_bytes = sum(x.numel() * x.element_size() for x in (a, b, got) if x is not None)  # a broadcast operand once
    bound_ms, bound_by = bound(n_bytes, n * LIE_FLOPS[op], PEAK_F64_PER_S if dt == "float64" else PEAK_F32_PER_S)
    print(f"{label} ({inputs}): {'bit-equal to' if exact else f'{rel:.3e} of the largest entry from'} the plain "
          f"version; kernel {ms * 1e3:.1f} us/call (events), device {fmt_us(dev_ms)}; plain {plain_ms * 1e3:.1f} "
          f"us/call (events), {plain_kernels} kernels, {fmt_us(plain_dev_ms)} (device); bound "
          f"{bound_ms * 1e3:.4f} us ({bound_by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, plain_kernels=plain_kernels,
                plain_device_ms=plain_dev_ms, max_abs_err=float((got - want).abs().max()), rel_err=rel,
                bit_equal=exact, bound_ms=bound_ms, bound_by=bound_by, inputs=inputs)


def phase_lie(device):
    """The Lie-group kernel against its plain version at every instance of
    one eager flagship scan (lie_inputs), in f64 and f32 (the f32-belief
    mode's instantiation), on the scan's own operands; then LIE_COUNTER
    starts again from 0, so that the kernels line counts the main paths'
    launches. Returns the records by (op, dtype, batch shape) and the
    scan's launches by instance."""
    import torch
    from gcslam_torch.ops import se3

    rec = lie_inputs(device)
    print(f"Lie-group launches of flagship scan {EIGH_RECORD_AFTER}: {sum(rec.launches.values())} in "
          f"{len(rec.launches)} instances: "
          + ", ".join(f"{k[0]} {k[1]} {k[2]} x{v}" for k, v in sorted(rec.launches.items())))
    records = {key: check_lie(key, a, b, eps, "flagship scan") for key, (a, b, eps) in sorted(rec.inputs.items())}
    for (op, dt, batch), (a, b, eps) in sorted(rec.inputs.items()):
        for dtype in (torch.float64, torch.float32):
            key = (op, str(dtype).replace("torch.", ""), batch)
            if key not in records:
                records[key] = check_lie(key, a.to(dtype), None if b is None else b.to(dtype), eps,
                                         f"flagship scan, cast to {key[1]}")
    se3.LIE_COUNTER.reset()
    return records, dict(rec.launches)


def phase_lie_paths(records: dict, launches: dict) -> None:
    """Phase 2 on the paths' own operands: every Lie-group instance the
    main paths launched (`launches`) that phase_lie did not hold is held
    against its plain version on its first operands (LIE_SEEN); an
    instance with no operands recorded fails. Adds the records."""
    new = sorted(k for k, n in launches.items() if n > 0 and k not in records)
    missing = [k for k in new if k not in LIE_SEEN.inputs]
    if missing:
        fail(f"Lie-group instances the main paths launched with no operands recorded outside a capture: {missing}")
    for key in new:
        records[key] = check_lie(key, *LIE_SEEN.inputs[key], inputs=f"{LIE_FIRST.get(key, 'a main path')}'s own")
    print(f"lie: {len(new)} more instances of the main paths held against the plain versions on their own operands; "
          f"{len(records)} instances in all")


def phase_eigh(device):
    """eigh3, psd3 and eigh_sym against their plain versions on the inputs
    of one flagship scan, at each of its instances, in f64 and f32; returns
    the records keyed by (kernel, dtype, batch shape) and the launches a
    scan of each recorded instance."""
    import torch

    rec = eigh_inputs(device)
    per_scan = rec.launches
    print("eigen instances of flagship scan " + str(EIGH_RECORD_AFTER) + ": "
          + ", ".join(f"{k[0]} {k[1]} {k[2]} x{v}" for k, v in sorted(per_scan.items()))
          + f"; {sum(v for k, v in per_scan.items() if k[0] == 'psd3')} psd3 + "
          f"{sum(v for k, v in per_scan.items() if k[0] == 'eigh3')} eigh3 launches")
    records = {}
    for key, M0 in sorted(rec.inputs.items()):
        for dtype in (torch.float64, torch.float32):
            k = (key[0], str(dtype).replace("torch.", ""), key[2])
            if k not in records:
                records[k] = check_eigen(k, M0.to(dtype), rec.eps.get(key))
                if k[0] == "psd3":
                    records[k]["projection_kernels_of_20"] = check_projection_kernels(M0.to(dtype), rec.eps[key])
    return records, per_scan


def phase_eigh_random(device) -> dict:
    """eigh_sym on random spectra at the step's 22 x 22 batches (f64): the
    kernel's time is the same for any input, torch.linalg.eigh's is not, so
    the comparison with the library is made on a second kind of input
    beside the flagship scan's graded information matrices."""
    import numpy as np
    import torch

    rng = np.random.default_rng(EIGH_RANDOM_SEED)
    out = {}
    for B in (1, 4):
        A = rng.normal(size=(B, 22, 22))
        M = torch.as_tensor(A @ np.swapaxes(A, -1, -2) - 11.0 * np.eye(22), device=device)
        rec = check_eigh("eigh_sym", M, inputs="random spectrum")
        out[f"float64 {(B, 22, 22)}"] = {k: rec[k] for k in ("device_ms", "library_device_ms", "library_ms",
                                                           "chain_floor_ms", "bit_equal")}
    return out


def phase_eigh_paths(records: dict) -> None:
    """Phase 2 on the paths' own inputs: every eigh instance the main paths
    launched that phase_eigh did not hold is held against its plain version
    on its first input (EIGH_SEEN); an instance with no input recorded
    fails. Adds the records."""
    new = sorted(set(EIGH_LAUNCHES) - set(records))
    missing = [k for k in new if k not in EIGH_SEEN.inputs]
    if missing:
        fail(f"eigh instances the main paths launched with no input recorded outside a capture: {missing}")
    for key in new:
        records[key] = check_eigen(key, EIGH_SEEN.inputs[key], EIGH_SEEN.eps.get(key))
    print(f"eigh: {len(new)} more instances of the main paths held against the plain versions on their own inputs; "
          f"{len(records)} instances in all")


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
    """Raster kernel vs plain at the render shapes; returns the records,
    keyed by (H, W): RenderParams()'s 240 x 320 and the viewer's 360 x 480."""
    from gcslam_torch.outputs import raster

    records = {}
    for case_i, (P, H, W) in enumerate(RASTER_CASES):
        s, params = raster_scene(P, H, W, device, seed=11 + case_i)
        label = f"P={P} {H}x{W}"
        err, drawn = check_raster(s, H, W, params.log_clip, label)
        if drawn <= 0.2:
            fail(f"raster {label}: only {100 * drawn:.1f} % of pixels drawn")
        call = lambda: raster.composite_splats(s, H, W, params.log_clip)  # noqa: E731
        ms = time_call(call, n=50)
        dev_ms = device_ms(call, "raster_kernel", label=f"raster {label}")
        plain_ms = time_call(lambda: raster.composite_splats_reference(s, H, W, params.log_clip), n=2)
        pairs, box_pairs, warp_share = raster_work(s, H, W, params.log_clip)
        bound_ms, bound_by = bound(P * 11 * 4 + H * W * 5 * 4, RASTER_FLOPS_PER_PAIR * pairs, PEAK_F32_PER_S)
        print(f"raster {label}: kernel {ms * 1e3:.1f} us/call (events), device {fmt_us(dev_ms)}, "
              f"plain {plain_ms * 1e3:.1f} us/call, {pairs} pairs with w > 0, bound {bound_ms * 1e3:.3f} us "
              f"({bound_by}); {box_pairs} pairs in the tiles' clip boxes, {100 * warp_share:.1f} % of their "
              f"(warp, splat) pairs with some w > 0")
        records[(H, W)] = dict(shape=[P, H, W], ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=err,
                               bound_ms=bound_ms, bound_by=bound_by)
    return records


@contextlib.contextmanager
def sinkhorn_shapes():
    """The problem shape of every Sinkhorn launch in the block, from the
    launch counter (sinkhorn.COUNTER, which the compiled step credits at
    each replay), a single problem as (N, K): read at the block's end from
    the counter's last reset inside it."""
    from gcslam_torch.ops import sinkhorn

    shapes = set()
    try:
        yield shapes
    finally:
        shapes.update(s[1:] if s[0] == 1 else s for s in sinkhorn.COUNTER.shapes)


def replay(device, cfg, run, label):
    """Warm-up, then one timed run_bag over all scans (replays of the
    compiled step the warm-up captured); returns (final state, outputs,
    ms/scan, Sinkhorn launches, ATE, the transfer ledger). The timed run's
    eigh launches are credited to `label` and stay in the eigh counters."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.models import runner
    from gcslam_torch.ops import sinkhorn
    from gcslam_torch.utils.profiling import COUNTERS

    runner.run_bag(run.batches[:N_WARMUP], cfg, device=device)
    torch.cuda.synchronize()
    sinkhorn.COUNTER.reset()
    COUNTERS.reset()
    with eigh_counted(label):
        t0 = time.perf_counter()
        state, out = runner.run_bag(run.batches, cfg, device=device)
        ledger = COUNTERS.cert()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = sinkhorn.COUNTER.launches
    if (ledger["h2d_calls"], ledger["d2h_bytes"], ledger["host_syncs"]) != (1, 0, 0):
        fail(f"{label}: run_bag's transfer ledger before the gather is {ledger}: expected one host-to-device "
             "call, no device-to-host read and no host sync")

    poses = out.pose.cpu().numpy()
    n = len(run.batches)
    if poses.shape != (n, 6) or not np.all(np.isfinite(poses)):
        fail(f"{label}: poses not finite or of wrong shape {poses.shape}")
    ate = compute_ate(poses, run.gt_poses, align="initial")
    ms_scan = 1e3 * elapsed / n
    print(f"{label}: {ms_scan:.2f} ms/scan over {n} scans (after {N_WARMUP} warm-up scans); "
          f"ATE {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg; "
          f"sinkhorn launches {launches}; transfer ledger before the gather: {ledger['h2d_calls']} host-to-device "
          f"call of {ledger['h2d_bytes']} B, {ledger['d2h_bytes']} B read back, {ledger['host_syncs']} host syncs")
    if launches != cfg.map_icp_iters * n:
        fail(f"{label}: sinkhorn launched {launches} times, expected {cfg.map_icp_iters * n}")
    if ate["translation"]["rmse"] > GATE_ATE_TRANS_RMSE_M or ate["rotation_deg"]["rmse"] > GATE_ATE_ROT_RMSE_DEG:
        fail(f"{label} ATE gate: {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg")
    return state, out, ms_scan, launches, ate, ledger


def phase_flagship(device):
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig

    t0 = time.perf_counter()
    run = generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS), device=device)
    print(f"generated {N_SCANS} scans x {N_POINTS} points in {time.perf_counter() - t0:.1f} s")
    from gcslam_torch.ops import eigh

    cfg = PipelineConfig()
    from gcslam_torch.models import runner
    from gcslam_torch.utils import cuda_profile

    _, out, ms_scan, launches, ate, ledger = replay(device, cfg, run, "flagship path")
    n = len(run.batches)
    print(f"flagship path: eigen launches {eigh.PSD3_COUNTER.launches} psd3 + {eigh.EIGH3_COUNTER.launches} eigh3 + "
          f"{eigh.EIGH_SYM_COUNTER.launches} eigh_sym over the replays, {eigh.PSD3_COUNTER.launches / n:g} psd3 + "
          f"{eigh.EIGH3_COUNTER.launches / n:g} eigh3 + {eigh.EIGH_SYM_COUNTER.launches / n:g} eigh_sym a scan ("
          + ", ".join(f"{k[0]} {k[1]} {k[2]} x{v}" for k, v in sorted(eigh_counts().items())) + ")")
    prof = cuda_profile.profile_record(lambda: runner.run_bag(run.batches[N_WARMUP:N_WARMUP + N_PROFILE_SCANS], cfg,
                                                              device=device), N_PROFILE_SCANS)
    print(f"flagship path: {N_PROFILE_SCANS} replayed scans profiled: {fmt_profile(prof)}")
    return run, cfg, out, ms_scan, launches, ate, ledger


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
    """ms per frame of the camera frontend alone on one rendered frame, on
    the generator's default route: corners, robust depth and plane fit in
    the C++ stage on the host, the lift and base-frame move on the card;
    host clock around 20 calls, synchronized."""
    import torch
    from gcslam_torch import constants as C
    from gcslam_torch.frontend import camera as cam_mod
    from gcslam_torch.frontend import synthetic as syn

    traj = syn.build_trajectory(cfg_syn)
    pos, yaw, _, _, _ = traj(1.0)
    gray, depth, rgb, R_wc, origin = syn._render_rgbd(pos, yaw, cfg_syn)
    rng = np.random.default_rng(0)
    lidar = rng.normal(0, 3, (N_POINTS, 3)) + [0, 0, 6]
    w = np.ones(N_POINTS)
    intr = cam_mod.PinholeIntrinsics(cfg_syn.cam_fx, cfg_syn.cam_fx, cfg_syn.cam_w / 2.0, cfg_syn.cam_h / 2.0)

    def one():
        f = cam_mod.extract_camera_features_native(gray, depth, rgb, intr, lidar, w, n_feat=C.N_FEAT, device=device)
        return cam_mod.features_to_base_frame(f, syn.T_BASE_CAM)

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        one()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 20


def phase_camera(device):
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig

    cfg_syn = SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS, with_camera=True)
    with eigh_counted("camera frontend (generate)"):  # the plane fit of every frame's features
        t0 = time.perf_counter()
        run = generate(cfg_syn, device=device)
        gen_s = time.perf_counter() - t0
    fe_ms = frontend_ms(device, cfg_syn)
    n_cam = [int(b.cam_valid.sum()) for b in run.batches]
    print(f"generated {N_SCANS} camera scans in {gen_s:.1f} s (raycasts and the C++ corner stage on the host, the "
          f"lift on the card: {fe_ms:.2f} ms/frame); valid camera features per scan {min(n_cam)}-{max(n_cam)}")
    if min(n_cam) < MIN_CAM_FEATURES:
        fail(f"camera frontend found only {min(n_cam)} features in a frame")

    # record the Sinkhorn problem shapes of the camera path
    with sinkhorn_shapes() as shapes:
        cfg = PipelineConfig(with_camera=True)
        state, out, ms_scan, launches, ate, _ = replay(device, cfg, run, "camera path")
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
    if raster.COUNTER.launches != before + VIEWER_RENDERS:
        fail("viewer: the renders did not go through the raster kernel")


def profile_scans(device, cfg, batches, n: int = N_PROFILE_SCANS):
    """profile_record over n scans after a 5-scan warm-up, of the eager step
    ("eager") and of run_bag's compiled-step replays ("graph")."""
    import torch
    from gcslam_torch.models import runner
    from gcslam_torch.utils.cuda_profile import profile_record

    state, _ = runner.run_bag(batches[:N_WARMUP], cfg, device=device)
    torch.cuda.synchronize()
    span = batches[N_WARMUP:N_WARMUP + n]
    return {"eager": profile_record(lambda: runner.eager_steps(state, span, cfg), n),
            "graph": profile_record(lambda: runner.run_bag(span, cfg, state=state, device=device), n)}


def fmt_profile(p) -> str:
    def f(x, spec):
        return "not measured" if x is None else format(x, spec)

    def one(q):
        return (f"{f(q['launch_calls_per_scan'], '.1f')} launch calls/scan, {f(q['graph_launches_per_scan'], '.0f')} "
                f"graph launches/scan, {f(q['device_kernels_per_scan'], '.0f')} device kernels/scan, device busy "
                f"{f(q['device_busy_ms_per_scan'], '.2f')} ms of {q['profiled_span_ms_per_scan']:.1f} ms per "
                f"profiled scan ({f(None if q['device_busy_share'] is None else 100 * q['device_busy_share'], '.1f')}"
                " %)")

    if "eager" not in p:  # one record (the sweep's)
        return one(p)
    return f"eager step: {one(p['eager'])}; compiled step: {one(p['graph'])}"


def phase_per_hypothesis(device, run, ate_flag):
    """The per-hypothesis map branch at production budgets; returns its
    record, the shared-extraction variant's and the Sinkhorn launches."""
    import torch
    from gcslam_torch import constants as C
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import sinkhorn

    cfg = PipelineConfig(**PER_HYP)
    expected = (C.K_HYP, cfg.n_surfel, cfg.k_assoc)
    with sinkhorn_shapes() as shapes:
        _, _, ms_scan, launches, ate, _ = replay(device, cfg, run, "per-hypothesis path")
    if shapes != {expected}:
        fail(f"per-hypothesis path: sinkhorn problem shapes {sorted(shapes)}, expected {expected}")
    d_ate = abs(ate["translation"]["rmse"] - ate_flag["translation"]["rmse"])
    print(f"per-hypothesis path: every sinkhorn launch is {expected} (one per GN round for all hypotheses); "
          f"|ATE - flagship ATE| {d_ate:.4f} m (bound {PER_HYP_ATE_BOUND_M} m)")
    if d_ate > PER_HYP_ATE_BOUND_M:
        fail(f"per-hypothesis path: ATE {d_ate:.4f} m from the flagship's")
    prof = profile_scans(device, cfg, run.batches)
    prof_flag = profile_scans(device, PipelineConfig(), run.batches)
    print(f"profile over {N_PROFILE_SCANS} scans, per-hypothesis: {fmt_profile(prof)}")
    print(f"profile over {N_PROFILE_SCANS} scans, flagship: {fmt_profile(prof_flag)}")

    # the shared-extraction level: one extraction, a GN chain per hypothesis
    cfg_se = PipelineConfig(map_share_extraction=True, map_gn_shared=False)
    n = N_SHARED_EXTRACTION_SCANS
    with sinkhorn_shapes() as shapes_se, eigh_counted("shared-extraction path"):
        sinkhorn.COUNTER.reset()
        t0 = time.perf_counter()
        _, out_se = runner.run_bag(run.batches[:n], cfg_se, device=device)
        torch.cuda.synchronize()
        ms_se = 1e3 * (time.perf_counter() - t0) / n
        launches_se = sinkhorn.COUNTER.launches
    if not torch.isfinite(out_se.pose).all():
        fail("shared-extraction path: non-finite poses")
    if launches_se != cfg_se.map_icp_iters * n or shapes_se != {expected}:
        fail(f"shared-extraction path: {launches_se} launches on {sorted(shapes_se)}, expected "
             f"{cfg_se.map_icp_iters * n} on {expected}")
    print(f"shared-extraction path: {ms_se:.2f} ms/scan over {n} scans (cold, no warm-up), {launches_se} "
          f"sinkhorn launches on {expected}")
    record = {"ms_per_scan": ms_scan, "n_scans": N_SCANS, "ate_m": ate["translation"]["rmse"],
              "ate_deg": ate["rotation_deg"]["rmse"], "ate_minus_flagship_m": d_ate,
              "sinkhorn_launches": launches, "sinkhorn_shape": list(expected), "profile": prof,
              "flagship_profile": prof_flag}
    record_se = {"ms_per_scan_cold": ms_se, "n_scans": n, "sinkhorn_launches": launches_se,
                 "sinkhorn_shape": list(expected)}
    return record, record_se, launches + launches_se


def phase_live(device, run, out_flag):
    """run_chunked / run_stream / loop closure / checkpoint; returns the
    record and the Sinkhorn launches of the map-on runs."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.frontend.loop import LoopConfig, LoopDetector
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner, scan_step
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import sinkhorn
    from gcslam_torch.utils import checkpoint

    cfg = PipelineConfig()
    expected = [cfg.n_surfel, cfg.k_assoc]
    with sinkhorn_shapes() as shapes, eigh_counted("run_chunked"):
        sinkhorn.COUNTER.reset()
        t0 = time.perf_counter()
        state_c, out_c = runner.run_chunked(run.batches, cfg, chunk=CHUNK, device=device)
        torch.cuda.synchronize()
        ms_c = 1e3 * (time.perf_counter() - t0) / len(run.batches)
        launches_c = sinkhorn.COUNTER.launches
    if not torch.equal(out_c.pose, out_flag.pose):
        fail(f"run_chunked differs from run_bag: max |dpose| {(out_c.pose - out_flag.pose).abs().max().item():.3e}")
    ate_c = compute_ate(out_c.pose.cpu().numpy(), run.gt_poses, align="initial")["translation"]["rmse"]
    print(f"run_chunked(chunk={CHUNK}): {ms_c:.2f} ms/scan, poses bit-equal to run_bag's, ATE {ate_c:.4f} m, "
          f"{launches_c} sinkhorn launches")
    if ate_c > GATE_CHUNK_ATE_TRANS_RMSE_M or launches_c != cfg.map_icp_iters * len(run.batches):
        fail(f"run_chunked: ATE {ate_c:.4f} m, {launches_c} launches")

    stream_dir = os.path.join(OUT_DIR, "stream")
    status_path = os.path.join(OUT_DIR, "status.jsonl")
    n = N_STREAM_SCANS
    with sinkhorn_shapes() as shapes_s, eigh_counted("run_stream"):
        sinkhorn.COUNTER.reset()
        t0 = time.perf_counter()
        _, out_s = runner.run_stream(run.batches[:n], cfg, map_stream_dir=stream_dir, map_stream_every=5,
                                     status_path=status_path, status_every=3, device=device)
        ms_s = 1e3 * (time.perf_counter() - t0) / n
        launches_s = sinkhorn.COUNTER.launches
    if shapes | shapes_s != {tuple(expected)}:
        fail(f"live modes: sinkhorn problem shapes {sorted(shapes | shapes_s)}, expected {tuple(expected)}")
    ate_s = compute_ate(out_s.pose.cpu().numpy(), run.gt_poses[:n], align="initial")["translation"]["rmse"]
    maps = [json.loads(line) for line in open(os.path.join(stream_dir, "map_stream.jsonl"))]
    status = [json.loads(line) for line in open(status_path)]
    if [m["scan"] for m in maps] != [0, 5, n - 1] or [st["scan"] for st in status] != [0, 3, 6, 9]:
        fail(f"run_stream: map stream at {[m['scan'] for m in maps]}, status at {[st['scan'] for st in status]}")
    for m in maps:
        if np.load(os.path.join(stream_dir, m["file"]))["mu_world"].shape[0] != m["n_splats"]:
            fail(f"run_stream: snapshot {m['file']} does not hold {m['n_splats']} splats")
    if not torch.equal(out_s.pose, out_flag.pose[:n]) or launches_s != cfg.map_icp_iters * n:
        fail(f"run_stream: poses differ from run_bag's or {launches_s} launches")
    print(f"run_stream: {ms_s:.2f} ms/scan over {n} scans with both streams (poses bit-equal to run_bag's); "
          f"{len(maps)} map snapshots ({maps[-1]['n_splats']} splats last), {len(status)} status lines "
          f"(last dead_end {status[-1]['dead_end']})")

    loiter = generate(SyntheticConfig(**LOITER), device=device)
    det = LoopDetector(LoopConfig(**LOOP_CFG))
    with eigh_counted("loop closure (loitering world)"):
        t0 = time.perf_counter()
        _, out_l = runner.run_chunked(loiter.batches, PipelineConfig(with_map=False), chunk=8, loop_detector=det,
                                      device=device)
        ms_l = 1e3 * (time.perf_counter() - t0) / len(loiter.batches)
    poses_l = out_l.pose.cpu().numpy()
    fired = np.nonzero(out_l.tape.io_loop_weight.cpu().numpy() > 0)[0].tolist()
    xy = float(np.linalg.norm(poses_l[:, :2] - loiter.gt_poses[:, :2], axis=1).max())
    print(f"loop closure (loitering world, run_chunked(chunk=8), no map): {ms_l:.2f} ms/scan, loops fired at "
          f"scans {fired}, max xy error {xy:.3f} m")
    if not np.isfinite(poses_l).all() or not fired or xy >= LOITER_MAX_XY_M:
        fail(f"loop closure: fired {fired}, max xy error {xy:.3f} m")

    path = os.path.join(OUT_DIR, "state.npz")
    checkpoint.save_state(path, state_c)
    back = checkpoint.load_state(path, scan_step.init_state(cfg, device=device))
    leaves, leaves_back = checkpoint.state_leaves(state_c), checkpoint.state_leaves(back)
    if len(leaves) != len(leaves_back) or not all(b.is_cuda and torch.equal(a, b)
                                                  for a, b in zip(leaves, leaves_back)):
        fail("checkpoint: the loaded state differs from the saved one")
    print(f"checkpoint: {len(leaves)} leaves saved and loaded on the card, bit-equal "
          f"({os.path.getsize(path) / 1e6:.1f} MB npz)")
    record = {"chunked": {"ms_per_scan": ms_c, "chunk": CHUNK, "bit_equal_to_run_bag": True, "ate_m": ate_c,
                          "sinkhorn_launches": launches_c, "sinkhorn_shape": expected},
              "stream": {"ms_per_scan": ms_s, "n_scans": n, "ate_m": ate_s, "map_snapshots": len(maps),
                         "status_lines": len(status), "sinkhorn_launches": launches_s, "sinkhorn_shape": expected},
              "loop": {"ms_per_scan": ms_l, "n_scans": len(loiter.batches), "fired_at": fired, "max_xy_m": xy},
              "checkpoint": {"leaves": len(leaves), "bit_equal": True}}
    return record, launches_c + launches_s


def phase_options(device, run):
    """The four filter options over the first N_OPTION_SCANS scans; returns
    their records and the Sinkhorn launches."""
    from gcslam_torch.models.config import PipelineConfig

    sub = SimpleNamespace(batches=run.batches[:N_OPTION_SCANS], gt_poses=run.gt_poses[:N_OPTION_SCANS])
    records, total = {}, 0
    for name, overrides in OPTIONS.items():
        cfg = PipelineConfig(**overrides)
        with sinkhorn_shapes() as shapes:
            _, _, ms_scan, launches, ate, _ = replay(device, cfg, sub, f"option {name}")
        expected = (cfg.n_surfel, cfg.k_assoc)
        if shapes != {expected}:
            fail(f"option {name}: sinkhorn problem shapes {sorted(shapes)}, expected {expected}")
        records[name] = {"ms_per_scan": ms_scan, "n_scans": N_OPTION_SCANS, "ate_m": ate["translation"]["rmse"],
                         "ate_deg": ate["rotation_deg"]["rmse"], "sinkhorn_launches": launches,
                         "sinkhorn_shape": list(expected)}
        total += launches
    return records, total


def check_artifacts(out_dir: str, n: int) -> None:
    """Every artifact of the eval run exists and parses."""
    for name in BAG_ARTIFACTS:
        path = os.path.join(out_dir, name)
        if not os.path.exists(path):
            fail(f"bag replay: {name} was not written")
        if name.endswith(".json"):
            json.load(open(path))
        elif name.endswith(".jsonl"):
            lines = [json.loads(line) for line in open(path)]
            if len([x for x in lines if "event" not in x]) != n:
                fail(f"bag replay: {name} does not hold one line per scan")
        elif name.endswith(".tum"):
            if np.loadtxt(path).reshape(-1, 8).shape != (n, 8):
                fail(f"bag replay: {name} does not hold {n} poses")
        elif name.endswith(".npz"):
            with np.load(path) as z:
                if not z.files:
                    fail(f"bag replay: {name} is empty")
        elif name.endswith(".csv"):
            if not open(path).readline().startswith("key,value"):
                fail(f"bag replay: {name} has no key,value header")
        elif "<svg" not in open(path).read():
            fail(f"bag replay: {name} holds no panel")


def phase_bag(device, sk_bag):
    """A Kimera-schema bag written on the host, decoded and replayed through
    `gcslam_torch.eval.run`; returns its record and the Sinkhorn launches."""
    import dataclasses

    import torch
    from gcslam_torch.eval import run as eval_run
    from gcslam_torch.frontend import rosbag
    from gcslam_torch.frontend.bag_synth import write_synth_bag
    from gcslam_torch.frontend.synthetic import SyntheticConfig
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import config_from_file
    from gcslam_torch.ops import sinkhorn

    bag_dir = os.path.join(OUT_DIR, "bag")
    os.makedirs(bag_dir, exist_ok=True)
    bag, gt = os.path.join(bag_dir, "kimera_synth.db3"), os.path.join(bag_dir, "kimera_synth_gt.tum")
    if os.path.exists(bag):
        os.remove(bag)
    bag_cfg = dataclasses.replace(rosbag.bag_config_from_file(BAG_CONFIG), n_points=BAG_POINTS)
    t0 = time.perf_counter()
    summary = write_synth_bag(bag, SyntheticConfig(**BAG_SYNTH), bag_cfg, gt_path=gt, cam_size=BAG_CAM_SIZE)
    write_s = time.perf_counter() - t0
    n = summary["n_scans"]
    print(f"bag written in {write_s:.1f} s: {summary['n_messages']} messages ({n} clouds of {BAG_SYNTH['n_points']} "
          f"returns, {summary['n_imu']} IMU, {summary['n_odom']} odometry, {summary['n_cam_frames']} RGB-D frames "
          f"at {BAG_CAM_SIZE[0]} x {BAG_CAM_SIZE[1]}), {os.path.getsize(bag) / 1e6:.1f} MB")

    cfg = config_from_file(BAG_CONFIG, with_camera=False)
    expected = (cfg.n_surfel, cfg.k_assoc)
    args = ["--bag", bag, "--config", BAG_CONFIG, "--gt", gt, "--points", str(BAG_POINTS), "--no-camera"]
    out_dir = os.path.join(bag_dir, "run")
    with sinkhorn_shapes() as shapes, eigh_counted("bag eval.run"):
        sinkhorn.COUNTER.reset()
        t0 = time.perf_counter()
        metrics = eval_run.main(args + ["--out", out_dir])
        run_s = time.perf_counter() - t0
        launches = sinkhorn.COUNTER.launches
    check_artifacts(out_dir, n)
    audit = json.load(open(os.path.join(out_dir, "audit.json")))
    poses = np.load(os.path.join(out_dir, "diagnostics.npz"))["poses"]
    ate, rpe = metrics["ate"], metrics["rpe"]["1m"]
    ate_m, ate_deg = ate["translation"]["rmse"], ate["rotation_deg"]["rmse"]
    jax_m = [m for m, _ in JAX_BAG_ATE.values()]
    print(f"eval.run on the bag: {run_s:.1f} s in all (load_bag {metrics['load_s']:.2f} s, replay "
          f"{metrics['wall_s']:.2f} s); ATE {ate_m:.4f} m / {ate_deg:.4f} deg, RPE 1 m {rpe['translation']['rmse']:.4f} "
          f"m / {rpe['rotation_deg']['rmse']:.4f} deg ({rpe['n_pairs']} pairs); audit "
          f"{'all pass' if audit['all_pass'] else 'FAILED'} ({len(audit) - 1} checks); sinkhorn launches {launches} "
          f"on {sorted(shapes)}")
    print(f"JAX package on the same bag: ATE {JAX_BAG_ATE['config'][0]:.4f} m / {JAX_BAG_ATE['config'][1]:.4f} deg at "
          f"the config's extrinsic (|port - JAX| {abs(ate_m - JAX_BAG_ATE['config'][0]):.4f} m), "
          f"{min(jax_m):.4f}-{max(jax_m):.4f} m over the extrinsic nudges {list(BAG_LIDAR_X)}")
    if any(m > REHEARSAL_GATE[0] or d > REHEARSAL_GATE[1] for m, d in JAX_BAG_ATE.values()):
        print(f"note: the JAX package's ATE on this bag is above the rehearsal gate {REHEARSAL_GATE}")
    if poses.shape != (n, 6) or not np.isfinite(poses).all():
        fail(f"bag replay: poses not finite or of shape {poses.shape}")
    if not audit["all_pass"]:
        fail(f"bag replay: audit failed: {[k for k, v in audit.items() if isinstance(v, dict) and not v['pass']]}")
    if launches != cfg.map_icp_iters * n or shapes != {expected}:
        fail(f"bag replay: {launches} sinkhorn launches on {sorted(shapes)}, expected {cfg.map_icp_iters * n} "
             f"on {expected}")
    if not min(jax_m) - BAG_ATE_BOUND_M <= ate_m <= max(jax_m) + BAG_ATE_BOUND_M:
        fail(f"bag replay: ATE {ate_m:.4f} m is more than {BAG_ATE_BOUND_M} m outside the JAX package's "
             f"{min(jax_m):.4f}-{max(jax_m):.4f} m")
    if ate_m > REHEARSAL_GATE[0] or ate_deg > REHEARSAL_GATE[1]:
        fail(f"bag replay: ATE {ate_m:.4f} m / {ate_deg:.4f} deg is above the rehearsal gate {REHEARSAL_GATE}")

    # the port's own spread: a nudge of the LiDAR extrinsic
    x_nudged = [BAG_LIDAR_X[PORT_BAG_NUDGE]] + list(bag_cfg.T_base_lidar)[1:]
    m = eval_run.main(args + ["--frontend-set", f"T_base_lidar={json.dumps(x_nudged)}",
                              "--out", os.path.join(bag_dir, f"run_{PORT_BAG_NUDGE}")])
    nudged = (m["ate"]["translation"]["rmse"], m["ate"]["rotation_deg"]["rmse"])
    print(f"port at the nudge {PORT_BAG_NUDGE}: ATE {nudged[0]:.4f} m / {nudged[1]:.4f} deg; {ate_m:.4f} m with "
          f"the config's")

    # the frontend alone, then the replay timed after a warm-up
    t0 = time.perf_counter()
    batches, _, _ = rosbag.load_bag(bag, config=dataclasses.replace(bag_cfg, with_camera=False), device=device)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    state, _ = runner.run_bag(batches[:N_WARMUP], cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run_bag(batches[N_WARMUP:], cfg, state=state, device=device)
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t0) / (len(batches) - N_WARMUP)
    print(f"bag frontend: decode + load_bag {load_ms:.2f} ms/scan; replay {replay_ms:.2f} ms/scan over "
          f"{len(batches) - N_WARMUP} scans after {N_WARMUP}; sinkhorn at {expected}: device "
          f"{fmt_us(sk_bag['device_ms'])}/call, events {sk_bag['ms'] * 1e3:.1f} us/call")
    record = {"n_scans": n, "n_returns": BAG_SYNTH["n_points"], "n_points": BAG_POINTS, "camera": False,
              "bag_write_s": write_s, "load_ms_per_scan": load_ms, "replay_ms_per_scan": replay_ms,
              "eval_run_s": run_s, "ate_m": ate_m, "ate_deg": ate_deg, "rpe_1m_m": rpe["translation"]["rmse"],
              "rpe_1m_deg": rpe["rotation_deg"]["rmse"], "ate_nudged": {PORT_BAG_NUDGE: nudged}, "jax_ate": JAX_BAG_ATE,
              "audit_checks": len(audit) - 1, "sinkhorn_launches": launches, "sinkhorn_shape": list(expected),
              "sinkhorn_512": sk_bag}
    return record, launches


def phase_canonical(device, sk_rec, rs_rec):
    """The canonical camera-on bag through `eval.run` with the live view;
    returns its record, its Sinkhorn launches and the viewer's raster
    launches."""
    import dataclasses

    import torch
    from gcslam_torch.eval import run as eval_run
    from gcslam_torch.frontend import rosbag
    from gcslam_torch.models.config import config_from_file
    from gcslam_torch.ops import sinkhorn
    from gcslam_torch.outputs import raster
    from gcslam_torch.tools import make_synth_bag, view_splats

    d = os.path.join(OUT_DIR, "canonical")
    os.makedirs(d, exist_ok=True)
    bag, gt, out_dir, live = (os.path.join(d, x) for x in ("kimera_synth.db3", "kimera_synth_gt.tum", "run", "live"))
    if os.path.exists(bag):
        os.remove(bag)
    t0 = time.perf_counter()
    summary = make_synth_bag.main(["--out", bag, "--gt", gt, "--config", BAG_CONFIG] + CANON_SYNTH)
    write_s = time.perf_counter() - t0
    n = summary["n_scans"]
    print(f"canonical bag written in {write_s:.1f} s: {summary['n_messages']} messages, {summary['n_cam_frames']} "
          f"RGB-D frames at 640 x 480, {os.path.getsize(bag) / 1e6:.1f} MB")

    cfg = config_from_file(BAG_CONFIG)
    expected = (cfg.n_surfel + cfg.n_feat, cfg.k_assoc)
    args = ["--bag", bag, "--config", BAG_CONFIG, "--gt", gt, "--chunk", "10", "--loop", "--live-view", live,
            "--out", out_dir]
    with sinkhorn_shapes() as shapes, eigh_counted("canonical bag eval.run"):
        sinkhorn.COUNTER.reset()
        t0 = time.perf_counter()
        metrics = eval_run.main(args)
        run_s = time.perf_counter() - t0
        launches = sinkhorn.COUNTER.launches
    check_artifacts(out_dir, n)
    audit = json.load(open(os.path.join(out_dir, "audit.json")))
    lines = [json.loads(line) for line in open(os.path.join(live, "live.jsonl"))]
    logged = [e["scan"] for e in lines if "pose" in e]
    ate, rpe = metrics["ate"], metrics["rpe"]["1m"]
    ate_m, ate_deg = ate["translation"]["rmse"], ate["rotation_deg"]["rmse"]
    jax_m = [m for m, _ in JAX_CANON_ATE.values()]
    rpe_m, rpe_deg = (rpe["translation"]["rmse"], rpe["rotation_deg"]["rmse"]) if rpe["translation"] else (None, None)
    print(f"eval.run on the canonical bag (camera on, --chunk 10 --loop --live-view): {run_s:.1f} s in all "
          f"(load_bag {metrics['load_s']:.2f} s, replay {metrics['wall_s']:.2f} s = "
          f"{1e3 * metrics['wall_s'] / n:.2f} ms/scan); ATE {ate_m:.4f} m / {ate_deg:.4f} deg, RPE 1 m "
          f"{rpe_m} m / {rpe_deg} deg ({rpe['n_pairs']} pairs); audit "
          f"{'all pass' if audit['all_pass'] else 'FAILED'}; live.jsonl {len(logged)} scan lines; sinkhorn "
          f"launches {launches} on {sorted(shapes)}")
    print(f"JAX package on the same bag: {min(jax_m):.4f}-{max(jax_m):.4f} m over {len(jax_m)} runs (the config's "
          f"extrinsic, one-ulp nudges, the port's state after scan 5); outside that range by "
          f"{max(0.0, min(jax_m) - ate_m, ate_m - max(jax_m)):.4f} m (bound {CANON_ATE_BOUND_M} m)")
    if not audit["all_pass"]:
        fail(f"canonical bag: audit failed: {[k for k, v in audit.items() if isinstance(v, dict) and not v['pass']]}")
    if logged != list(range(n)):
        fail(f"canonical bag: live.jsonl logs scans {logged[:5]}..., not one line per scan")
    if launches != cfg.map_icp_iters * n or shapes != {expected}:
        fail(f"canonical bag: {launches} sinkhorn launches on {sorted(shapes)}, expected {cfg.map_icp_iters * n} "
             f"on {expected}")
    if ate_m > REHEARSAL_GATE[0] or ate_deg > REHEARSAL_GATE[1]:
        fail(f"canonical bag: ATE {ate_m:.4f} m / {ate_deg:.4f} deg is above the rehearsal gate {REHEARSAL_GATE}")
    if not min(jax_m) - CANON_ATE_BOUND_M <= ate_m <= max(jax_m) + CANON_ATE_BOUND_M:
        fail(f"canonical bag: ATE {ate_m:.4f} m is more than {CANON_ATE_BOUND_M} m outside the JAX package's "
             f"{min(jax_m):.4f}-{max(jax_m):.4f} m")

    # the frontend alone, camera on and off: the camera's share of the load
    bag_cfg = rosbag.bag_config_from_file(BAG_CONFIG)
    load_ms = {}
    for cam in (True, False):
        t0 = time.perf_counter()
        batches, _, _ = rosbag.load_bag(bag, config=dataclasses.replace(bag_cfg, with_camera=cam), device=device)
        torch.cuda.synchronize()
        load_ms[cam] = 1e3 * (time.perf_counter() - t0) / len(batches)
    cam_share = (load_ms[True] - load_ms[False]) / load_ms[True]
    # one render of the result through the raster kernel
    before = raster.COUNTER.launches
    paths = view_splats.main([os.path.join(out_dir, "splat_export.npz"), "--traj",
                              os.path.join(out_dir, "trajectory.tum"), "--out", os.path.join(d, "views")])
    viewer_launches = raster.COUNTER.launches - before
    depth = np.load(paths["render_depth.npy"])
    if viewer_launches != 1 or not np.isfinite(depth).all():
        fail(f"canonical bag: the viewer made {viewer_launches} raster launches")
    print(f"canonical frontend: decode + load_bag {load_ms[True]:.2f} ms/scan with the camera, {load_ms[False]:.2f} "
          f"without (camera {100 * cam_share:.1f} %); sinkhorn at {expected}: device {fmt_us(sk_rec['device_ms'])}"
          f"/call; viewer render covered {100 * float((depth > 0).mean()):.1f} % (raster at 360 x 480: device "
          f"{fmt_us(rs_rec['device_ms'])}/call)")
    record = {"n_scans": n, "n_returns": 16384, "camera": True, "bag_write_s": write_s, "eval_run_s": run_s,
              "load_s": metrics["load_s"], "replay_ms_per_scan": 1e3 * metrics["wall_s"] / n,
              "load_ms_per_scan_camera": load_ms[True], "load_ms_per_scan_no_camera": load_ms[False],
              "camera_share_of_load": cam_share, "ate_m": ate_m, "ate_deg": ate_deg,
              "rpe_1m_m": rpe_m, "rpe_1m_deg": rpe_deg, "jax_ate": JAX_CANON_ATE, "audit_checks": len(audit) - 1, "live_scan_lines": len(logged),
              "sinkhorn_launches": launches, "sinkhorn_shape": list(expected), "viewer_raster_launches": viewer_launches}
    return record, launches, viewer_launches


def sweep_profile(device, cfg, runs, states, n: int):
    """profile_record over n sweep steps from `states`, traced with the
    CUDA activity alone (the runtime's launch calls and the device's
    kernels, copies and sets): tracing every host op as well, as phase 8
    does, costs ~15 s a profiled scan."""
    from gcslam_torch.parallel import sweep
    from gcslam_torch.utils.cuda_profile import profile_record

    rec = profile_record(lambda: sweep.run_sweep([r[SWEEP_WARMUP:SWEEP_WARMUP + n] for r in runs], cfg,
                                                 states=states, device=device), n, activities=("cuda",))
    return {**rec, "profiled_scans": n, "activities": "cuda"}


def phase_sweep(device, run, out_flag, ate_flag):
    """Replay sweeps: SWEEP_RUNS flagship runs through sweep_step, the
    R-scaling, the per-hypothesis sweep and repeat runs; returns the record
    and the Sinkhorn launches by instance (dtype, B, N)."""
    import torch
    from gcslam_torch import constants as C
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import sinkhorn
    from gcslam_torch.parallel import sweep

    cfg = PipelineConfig()
    K, N = cfg.k_assoc, cfg.n_surfel
    t0 = t_phase = time.perf_counter()
    worlds = [run] + [generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS, seed=s), device=device)
                      for s in range(1, SWEEP_RUNS)]
    runs = [w.batches for w in worlds]
    print(f"generated {SWEEP_RUNS - 1} more flagship worlds (seeds 1-{SWEEP_RUNS - 1}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # the vmap rule: one launch for all problems, equal to per-problem launches
    Cm, a, b, _ = sinkhorn_inputs(SWEEP_RUNS, N, K, torch.float64, device, seed=14)
    sinkhorn.COUNTER.reset()
    folded = torch.func.vmap(torch.func.vmap(lambda c, x: sinkhorn.sinkhorn_unbalanced(c, x, b[0], **SINKHORN_ARGS)))(
        Cm.reshape(2, SWEEP_RUNS // 2, N, K), a.reshape(2, SWEEP_RUNS // 2, N))
    if sinkhorn.COUNTER.launches != 1 or sinkhorn.COUNTER.shapes != {(SWEEP_RUNS, N, K)}:
        fail(f"sweep: the vmapped sinkhorn made {sinkhorn.COUNTER.launches} launches on {sinkhorn.COUNTER.shapes}")
    per = torch.stack([sinkhorn.sinkhorn_unbalanced(Cm[i], a[i], b[0], **SINKHORN_ARGS) for i in range(SWEEP_RUNS)])
    if not torch.equal(folded.reshape(per.shape), per):
        fail("sweep: the vmapped sinkhorn differs from per-problem launches")
    print(f"sweep: vmapped sinkhorn (2, {SWEEP_RUNS // 2}, {N}, {K}) is one launch of B = {SWEEP_RUNS}, "
          f"bit-equal to {SWEEP_RUNS} per-problem launches")

    launches = {}

    def count(key, n):
        launches[key] = launches.get(key, 0) + n

    # the main path: SWEEP_RUNS runs over all scans; an op without a vmap
    # batching rule would run per sample and warn "There is a performance drop"
    sinkhorn.COUNTER.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, eigh_counted(f"sweep R={SWEEP_RUNS}"):
        warnings.simplefilter("always")
        _, outs, aggs = sweep.run_sweep(runs, cfg, device=device)
        torch.cuda.synchronize()
    ms_main = 1e3 * (time.perf_counter() - t0) / N_SCANS
    per_sample = sorted({str(w.message)[:120] for w in caught if "performance drop" in str(w.message)})
    if per_sample:
        fail(f"sweep: ops on vmap's per-sample path: {per_sample}")
    n_main, shapes = sinkhorn.COUNTER.launches, sinkhorn.COUNTER.shapes
    if n_main != cfg.map_icp_iters * N_SCANS or shapes != {(SWEEP_RUNS, N, K)}:
        fail(f"sweep: {n_main} sinkhorn launches on {shapes}, expected {cfg.map_icp_iters * N_SCANS} on "
             f"{(SWEEP_RUNS, N, K)}")
    count(("float64", SWEEP_RUNS, N), n_main)
    poses = outs.pose.cpu().numpy()
    if poses.shape != (SWEEP_RUNS, N_SCANS, 6) or not np.all(np.isfinite(poses)):
        fail(f"sweep: poses not finite or of wrong shape {poses.shape}")
    ates = [compute_ate(p, w.gt_poses, align="initial") for p, w in zip(poses, worlds)]
    for r, ate in enumerate(ates):
        if ate["translation"]["rmse"] > GATE_ATE_TRANS_RMSE_M or ate["rotation_deg"]["rmse"] > GATE_ATE_ROT_RMSE_DEG:
            fail(f"sweep run {r} ATE gate: {ate['translation']['rmse']:.4f} m / {ate['rotation_deg']['rmse']:.4f} deg")
    seeds_apart = min(float(np.abs(poses[i] - poses[j]).max()) for i in range(SWEEP_RUNS) for j in range(i))
    if seeds_apart <= SWEEP_SEEDS_DIFFER_M:
        fail(f"sweep: two seeds' trajectories within {seeds_apart:.3e} m")
    d_pose = float(np.abs(poses[0] - out_flag.pose.cpu().numpy()).max())
    d_ate = abs(ates[0]["translation"]["rmse"] - ate_flag["translation"]["rmse"])
    bit_equal = bool(np.array_equal(poses[0], out_flag.pose.cpu().numpy()))
    if d_ate > SWEEP_RUN0_ATE_BOUND_M:
        fail(f"sweep run 0: ATE {d_ate:.3e} m from phase 3's run_bag")
    spread = [float(a["pose_spread"]) for a in aggs]
    print(f"sweep of {SWEEP_RUNS} flagship runs x {N_SCANS} scans: {ms_main:.2f} ms/scan ({ms_main / SWEEP_RUNS:.2f} "
          f"per run, cold), {n_main} sinkhorn launches all on {(SWEEP_RUNS, N, K)}; ATE per run "
          f"{', '.join('%.4f' % a['translation']['rmse'] for a in ates)} m (max "
          f"{max(a['rotation_deg']['rmse'] for a in ates):.3f} deg); seeds >= {seeds_apart:.3e} m apart; run 0 vs "
          f"phase 3: max |d pose| {d_pose:.3e}, |d ATE| {d_ate:.3e} m, bit-equal {bit_equal}; final pose spread "
          f"{spread[-1]:.4f} m")

    # the cross-run witness: run 0 again beside the other seven runs in
    # reverse order; any dependence of a run on the others would show here,
    # batching's rounding (the same shapes) would not
    sinkhorn.COUNTER.reset()
    with eigh_counted("sweep witness"):
        _, outs_w, _ = sweep.run_sweep([r[:SWEEP_SCANS] for r in [runs[0]] + runs[:0:-1]], cfg, device=device)
    n_w, shapes = sinkhorn.COUNTER.launches, sinkhorn.COUNTER.shapes
    if n_w != cfg.map_icp_iters * SWEEP_SCANS or shapes != {(SWEEP_RUNS, N, K)}:
        fail(f"sweep witness: {n_w} sinkhorn launches on {shapes}, expected {cfg.map_icp_iters * SWEEP_SCANS} on "
             f"{(SWEEP_RUNS, N, K)}")
    count(("float64", SWEEP_RUNS, N), n_w)
    witness = outs_w.pose[0].cpu().numpy()
    if not np.array_equal(witness, poses[0, :SWEEP_SCANS]):
        fail(f"sweep witness: run 0 beside other runs differs by {np.abs(witness - poses[0, :SWEEP_SCANS]).max():.3e}"
             f" over {SWEEP_SCANS} scans")
    print(f"sweep witness: run 0 beside runs 7-1 is bit-equal to run 0 beside runs 1-7 over {SWEEP_SCANS} scans "
          f"({n_w} sinkhorn launches on {(SWEEP_RUNS, N, K)})")

    print(f"[sweep of {SWEEP_RUNS} runs: {time.perf_counter() - t_phase:.1f} s into phase 14]")

    # R-scaling: ms/scan and launches per scan after a warm-up, then a
    # profile (SWEEP_PROFILE_SCANS at R = 8, one scan at the others)
    scaling, repeat = {}, None
    for R in SWEEP_R:
        sub = runs[:R]
        states, _, _ = sweep.run_sweep([r[:SWEEP_WARMUP] for r in sub], cfg, device=device)
        torch.cuda.synchronize()
        sinkhorn.COUNTER.reset()
        with eigh_counted(f"sweep R={R}"):
            t0 = time.perf_counter()
            _, outs_r, _ = sweep.run_sweep([r[SWEEP_WARMUP:SWEEP_WARMUP + SWEEP_SCANS] for r in sub], cfg,
                                           states=states, device=device)
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / SWEEP_SCANS
        n_r, shapes = sinkhorn.COUNTER.launches, sinkhorn.COUNTER.shapes
        if n_r != cfg.map_icp_iters * SWEEP_SCANS or shapes != {(R, N, K)}:
            fail(f"sweep R={R}: {n_r} sinkhorn launches on {shapes}, expected {cfg.map_icp_iters * SWEEP_SCANS} "
                 f"on {(R, N, K)}")
        count(("float64", R, N), n_r)
        if R == 2:  # the repeat run: the same sweep again from the same states
            sinkhorn.COUNTER.reset()
            with eigh_counted(f"sweep R={R}"):
                _, outs_rep, _ = sweep.run_sweep([r[SWEEP_WARMUP:SWEEP_WARMUP + SWEEP_SCANS] for r in sub], cfg,
                                                 states=states, device=device)
            n_rep, shapes = sinkhorn.COUNTER.launches, sinkhorn.COUNTER.shapes
            if n_rep != cfg.map_icp_iters * SWEEP_SCANS or shapes != {(R, N, K)}:
                fail(f"sweep repeat: {n_rep} sinkhorn launches on {shapes}, expected "
                     f"{cfg.map_icp_iters * SWEEP_SCANS} on {(R, N, K)}")
            count(("float64", R, N), n_rep)
            repeat = (outs_r.pose, outs_rep.pose)
        prof = sweep_profile(device, cfg, sub, states, SWEEP_PROFILE_SCANS if R == max(SWEEP_R) else 1)
        scaling[R] = {"ms_per_scan": ms, "ms_per_run_scan": ms / R, "sinkhorn_launches_per_scan": n_r / SWEEP_SCANS,
                      "profile": prof}
        print(f"sweep R={R}: {ms:.2f} ms/scan ({ms / R:.2f} per run) over {SWEEP_SCANS} scans after {SWEEP_WARMUP}; "
              f"{n_r / SWEEP_SCANS:.0f} sinkhorn launches/scan on {(R, N, K)}; profile: {fmt_profile(prof)} "
              f"[{time.perf_counter() - t_phase:.1f} s into phase 14]")

    # the per-hypothesis sweep: one launch per GN round for R x K_HYP problems
    cfg_h = PipelineConfig(map_gn_shared=False)
    B_h = 2 * C.K_HYP
    sinkhorn.COUNTER.reset()
    torch.cuda.synchronize()
    with eigh_counted("per-hypothesis sweep R=2"):
        t0 = time.perf_counter()
        _, outs_h, _ = sweep.run_sweep([r[:SWEEP_SCANS] for r in runs[:2]], cfg_h, device=device)
        torch.cuda.synchronize()
    ms_h = 1e3 * (time.perf_counter() - t0) / SWEEP_SCANS
    n_h, shapes_h = sinkhorn.COUNTER.launches, sinkhorn.COUNTER.shapes
    if n_h != cfg_h.map_icp_iters * SWEEP_SCANS or shapes_h != {(B_h, N, K)}:
        fail(f"per-hypothesis sweep: {n_h} launches on {shapes_h}, expected {cfg_h.map_icp_iters * SWEEP_SCANS} on "
             f"{(B_h, N, K)}")
    if not torch.isfinite(outs_h.pose).all():
        fail("per-hypothesis sweep: non-finite poses")
    count(("float64", B_h, N), n_h)
    print(f"per-hypothesis sweep R=2 (map_gn_shared=False): {ms_h:.2f} ms/scan over {SWEEP_SCANS} scans (cold), "
          f"{n_h} sinkhorn launches all on {(B_h, N, K)} [{time.perf_counter() - t_phase:.1f} s into phase 14]")

    if not torch.equal(*repeat):
        fail(f"sweep repeat runs differ: max |dpose| {(repeat[0] - repeat[1]).abs().max().item():.3e}")
    print(f"sweep determinism: two R=2 {SWEEP_SCANS}-scan sweeps give bit-equal poses")

    record = {"runs": SWEEP_RUNS, "n_scans": N_SCANS, "ms_per_scan": ms_main,
              "ate_m": [a["translation"]["rmse"] for a in ates], "ate_deg": [a["rotation_deg"]["rmse"] for a in ates],
              "run0_max_abs_dpose_vs_run_bag": d_pose, "run0_ate_minus_run_bag_m": d_ate,
              "run0_bit_equal_to_run_bag": bit_equal, "seeds_min_max_abs_dpose": seeds_apart,
              "final_pose_spread_m": spread[-1], "sinkhorn_launches": n_main,
              "run0_bit_equal_beside_other_runs": True, "witness_scans": SWEEP_SCANS,
              "scaling": {str(R): v for R, v in scaling.items()},
              "per_hypothesis_r2": {"ms_per_scan_cold": ms_h, "n_scans": SWEEP_SCANS, "sinkhorn_launches": n_h,
                                    "sinkhorn_shape": [B_h, N, K]}}
    return record, launches, poses


def _mesh_counters_reset() -> None:
    """A rank's counters to 0 before a family's run (the first call installs
    the rank's EIGH_SEEN and LIE_SEEN)."""
    from gcslam_torch.ops import collectives, se3, sinkhorn

    EIGH_SEEN.install()
    LIE_SEEN.install()
    sinkhorn.COUNTER.reset()
    eigh_reset()
    se3.LIE_COUNTER.reset()
    collectives.COUNTER.clear()


def _mesh_family_record(n_scans: int, seconds: float, warm_seconds=None, warm_scans=None):
    """A rank's counters after a family's run: Sinkhorn launches and
    shapes, eigh and Lie-group launches by instance and the rank's eigh and
    Lie-group operands so far, collectives by axis, ms/scan."""
    from gcslam_torch.ops import collectives, sinkhorn

    rec = {"sinkhorn_launches": sinkhorn.COUNTER.launches, "sinkhorn_shapes": sorted(sinkhorn.COUNTER.shapes),
           "eigh_launches": eigh_counts(), "eigh_inputs": EIGH_SEEN.host(),
           "lie_launches": lie_counts(), "lie_inputs": LIE_SEEN.host(),
           "collectives": dict(collectives.COUNTER), "n_scans": n_scans,
           "ms_per_scan_cold": 1e3 * seconds / n_scans}
    if warm_seconds is not None:
        rec["ms_per_scan"] = 1e3 * warm_seconds / warm_scans
    return rec


def mesh_one_card_rank(device) -> dict:
    """Phase 15 on one NCCL rank: the (run=1) mesh over MESH_ONE_CARD_RUNS
    flagship seeds, against run_sweep without a mesh, and the sharded
    checkpoint."""
    import torch
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.parallel import mesh as mesh_mod
    from gcslam_torch.parallel import sweep
    from gcslam_torch.utils import checkpoint as ckpt

    cfg = PipelineConfig()
    runs = [generate(SyntheticConfig(n_scans=MESH_ONE_CARD_SCANS, n_points=N_POINTS, seed=s), device=device).batches
            for s in range(MESH_ONE_CARD_RUNS)]
    mesh = mesh_mod.make_mesh(1)
    _mesh_counters_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs, _ = sweep.run_sweep(runs, cfg, mesh=mesh)
    torch.cuda.synchronize()
    rec = _mesh_family_record(MESH_ONE_CARD_SCANS, time.perf_counter() - t0)
    _, plain, _ = sweep.run_sweep(runs, cfg, device=device)

    first = [r[:MESH_CKPT_AT] for r in runs]
    rest = [r[MESH_CKPT_AT:] for r in runs]
    states, out_first, _ = sweep.run_sweep(first, cfg, mesh=mesh)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.abspath(os.path.join(OUT_DIR, "mesh_ckpt"))
    ckpt.save_state_sharded(path, states, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cont, _ = sweep.run_sweep(rest, cfg, states=states, mesh=mesh)
    torch.cuda.synchronize()
    rec["ms_per_scan"] = 1e3 * (time.perf_counter() - t0) / len(rest[0])
    like = sweep.shard_states(sweep.batched_init_state(cfg, MESH_ONE_CARD_RUNS, device=device), mesh)
    resumed = ckpt.load_state_sharded(path, like, mesh)
    restored_equal = all(torch.equal(a, b) for a, b in zip(ckpt.state_leaves(resumed), ckpt.state_leaves(states)))
    _, res, _ = sweep.run_sweep(rest, cfg, states=resumed, mesh=mesh)
    return {**rec, "pose": outs.pose.cpu().numpy(), "plain_pose": plain.pose.cpu().numpy(),
            "split_pose": torch.cat([out_first.pose, cont.pose], dim=1).cpu().numpy(),
            "resumed_pose": res.pose.cpu().numpy(), "cont_pose": cont.pose.cpu().numpy(),
            "restored_equal": restored_equal}


def mesh_shared_card_rank(device) -> dict:
    """Phase 15 on two gloo ranks sharing the one card: gloo's all_gather
    on CUDA tensors, and then the (run=1, hyp=2) per-hypothesis and
    (run=1, map=2) families against run_sweep without a mesh."""
    import torch
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import collectives
    from gcslam_torch.parallel import mesh as mesh_mod
    from gcslam_torch.parallel import sweep

    probe = mesh_mod.make_mesh(2).shard("run")
    got = collectives.all_gather([torch.full((2,), float(probe.index), device=device)], probe)
    if not torch.equal(got[0].cpu(), torch.tensor([[0.0, 0.0], [1.0, 1.0]])):
        raise AssertionError(f"gloo all_gather on CUDA tensors gave {got[0].tolist()}")
    runs = [generate(SyntheticConfig(n_scans=MESH_SHARED_CARD_SCANS, n_points=N_POINTS, seed=s), device=device).batches
            for s in range(MESH_ONE_CARD_RUNS)]
    out = {}
    for name, mesh, cfg in (("hyp", mesh_mod.make_mesh_2d(1, 2), PipelineConfig(map_gn_shared=False)),
                            ("map", mesh_mod.make_mesh_map(1, 2), PipelineConfig())):
        _mesh_counters_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs, _ = sweep.run_sweep(runs, cfg, mesh=mesh)
        torch.cuda.synchronize()
        rec = _mesh_family_record(MESH_SHARED_CARD_SCANS, time.perf_counter() - t0)
        _, plain, _ = sweep.run_sweep(runs, cfg, device=device)
        out[name] = {**rec, "mesh": dict(mesh.shape), "pose": outs.pose.cpu().numpy(),
                     "plain_pose": plain.pose.cpu().numpy()}
    return out


def mesh_cards_rank(device, n_cards: int) -> dict:
    """Phase 15 on n_cards NCCL ranks, one a card: the SWEEP_RUNS flagship
    seeds over N_SCANS scans on (run=n), (run=n/2, hyp=2) per hypothesis
    and (run=n/2, map=2); MESH_WARMUP scans, then the timed rest. After
    each family, this rank's block of runs over MESH_REF_SCANS scans again
    without a mesh at the family's config (split at MESH_WARMUP the same
    way), the reference its share of the family's poses is held to."""
    import torch
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.parallel import mesh as mesh_mod
    from gcslam_torch.parallel import sweep
    from gcslam_torch.utils.cuda_profile import profile_record

    runs = [generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS, seed=s), device=device).batches
            for s in range(SWEEP_RUNS)]
    out = {}
    for name, mesh, cfg in (("run", mesh_mod.make_mesh(n_cards), PipelineConfig()),
                            ("hyp", mesh_mod.make_mesh_2d(n_cards // 2, 2), PipelineConfig(map_gn_shared=False)),
                            ("map", mesh_mod.make_mesh_map(n_cards // 2, 2), PipelineConfig())):
        _mesh_counters_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, warm, _ = sweep.run_sweep([r[:MESH_WARMUP] for r in runs], cfg, mesh=mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, rest, aggs = sweep.run_sweep([r[MESH_WARMUP:] for r in runs], cfg, states=states, mesh=mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rec = _mesh_family_record(N_SCANS, t2 - t0, t2 - t1, N_SCANS - MESH_WARMUP)
        # after the main path's counters: the scans after the warm-up again, profiled
        prof = profile_record(lambda: sweep.run_sweep([r[MESH_WARMUP:MESH_WARMUP + MESH_PROFILE_SCANS] for r in runs],
                                                      cfg, states=states, mesh=mesh),
                              MESH_PROFILE_SCANS, activities=("cuda",))
        lo, hi = mesh.block("run", SWEEP_RUNS)
        block = [r[:MESH_REF_SCANS] for r in runs[lo:hi]]
        ref_states, ref_warm, _ = sweep.run_sweep([r[:MESH_WARMUP] for r in block], cfg, device=device)
        _, ref_rest, _ = sweep.run_sweep([r[MESH_WARMUP:] for r in block], cfg, states=ref_states, device=device)
        out[name] = {**rec, "mesh": dict(mesh.shape), "pose": torch.cat([warm.pose, rest.pose], dim=1).cpu().numpy(),
                     "final_pose_spread_m": float(aggs[-1]["pose_spread"]), "profile": prof, "ref_block": (lo, hi),
                     "ref_pose": torch.cat([ref_warm.pose, ref_rest.pose], dim=1).cpu().numpy()}
    return out


def _credit_ranks(label: str, recs) -> None:
    """Credit the ranks' eigh launches of a family's run to `label` and
    their Lie-group launches to LIE_LAUNCHES, and add their eigh and
    Lie-group operands to EIGH_SEEN and LIE_SEEN."""
    for rec in recs:
        eigh_credit(label, rec["eigh_launches"])
        EIGH_SEEN.merge(rec["eigh_inputs"], "cuda")
        LIE_LAUNCHES.update(rec["lie_launches"])
        LIE_SEEN.merge(rec["lie_inputs"], "cuda")


def _sinkhorn_check(label: str, rec: dict, n_scans: int, shape) -> None:
    want = 2 * n_scans  # map_icp_iters at PipelineConfig()
    if rec["sinkhorn_launches"] != want or rec["sinkhorn_shapes"] != [tuple(shape)]:
        fail(f"mesh {label}: {rec['sinkhorn_launches']} sinkhorn launches on {rec['sinkhorn_shapes']}, expected "
             f"{want} on {tuple(shape)}")


def _collectives_per_scan(rec: dict, n_sweeps: int = 1) -> dict:
    """Collectives a scan by axis, without the one gather of the outputs at
    the end of each of the n_sweeps run_sweep calls."""
    return {axis: (n - (n_sweeps if axis == "run" else 0)) / rec["n_scans"]
            for axis, n in sorted(rec["collectives"].items())}


def phase_mesh(device, sweep_poses):
    """The sweep over a device mesh: the (run=1) NCCL mesh with the sharded
    checkpoint, the 2-D families on two gloo ranks sharing the card, and
    with >= 2 cards the three families over all of them. Returns the
    record and the Sinkhorn launches by instance (dtype, B, N)."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch import constants as C
    from gcslam_torch.parallel import mesh as mesh_mod
    from gcslam_torch.parallel import sweep

    K, N = PipelineConfig().k_assoc, PipelineConfig().n_surfel
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    launches, record = {}, {"cards": n_cards}

    def count(key, n):
        launches[key] = launches.get(key, 0) + n

    # (run=1): one NCCL rank, bit-equal to run_sweep at R = 2 (the same shapes)
    t0 = time.perf_counter()
    one = mesh_mod.run_ranks(mesh_one_card_rank, 1, "cuda", timeout=MESH_TIMEOUT_S)[0]
    R = MESH_ONE_CARD_RUNS
    _sinkhorn_check("(run=1)", one, MESH_ONE_CARD_SCANS, (R, N, K))
    count(("float64", R, N), one["sinkhorn_launches"])
    _credit_ranks("mesh (run=1)", [one])
    want = {"run": MESH_ONE_CARD_SCANS + 1}  # the aggregates' pose gather a scan, the outputs' at the end
    if one["collectives"] != want:
        fail(f"mesh (run=1): collectives {one['collectives']}, expected {want}")
    if not np.all(np.isfinite(one["pose"])) or one["pose"].shape != (R, MESH_ONE_CARD_SCANS, 6):
        fail(f"mesh (run=1): poses of shape {one['pose'].shape}, or non-finite")
    if not np.array_equal(one["pose"], one["plain_pose"]):
        fail(f"mesh (run=1): differs from run_sweep at R = {R} by {np.abs(one['pose'] - one['plain_pose']).max():.3e}")
    if not np.array_equal(one["split_pose"], one["pose"]):
        fail("mesh (run=1): the run split at the checkpoint differs from the whole run")
    if not one["restored_equal"] or not np.array_equal(one["resumed_pose"], one["cont_pose"]):
        fail(f"mesh checkpoint: restored leaves equal {one['restored_equal']}, resumed run differs by "
             f"{np.abs(one['resumed_pose'] - one['cont_pose']).max():.3e}")
    print(f"mesh (run=1) on 1 NCCL rank: {R} flagship runs x {MESH_ONE_CARD_SCANS} scans bit-equal to run_sweep at "
          f"R = {R}; {one['ms_per_scan_cold']:.2f} ms/scan cold, {one['ms_per_scan']:.2f} ms/scan over the "
          f"{MESH_ONE_CARD_SCANS - MESH_CKPT_AT} scans after the checkpoint; "
          f"{one['sinkhorn_launches'] / MESH_ONE_CARD_SCANS:.0f} sinkhorn launches/scan on {(R, N, K)}; "
          f"collectives {one['collectives']}; sharded checkpoint after scan "
          f"{MESH_CKPT_AT}: restored bit-equal, resumed run bit-equal "
          f"[{time.perf_counter() - t0:.1f} s with the rank's start]")
    record["run1"] = {k: one[k] for k in ("ms_per_scan_cold", "ms_per_scan", "sinkhorn_launches", "collectives")}
    record["run1"].update(runs=R, n_scans=MESH_ONE_CARD_SCANS, bit_equal_to_run_sweep=True, checkpoint_bit_equal=True)

    # the 2-D families on two gloo ranks sharing the card
    t0 = time.perf_counter()
    shared = mesh_mod.run_ranks(mesh_shared_card_rank, 2, "cuda", timeout=MESH_TIMEOUT_S, backend="gloo")
    record["shared_card"] = {}
    for name, B in (("hyp", R * C.K_HYP // 2), ("map", R)):
        fam = shared[0][name]
        _sinkhorn_check(f"{fam['mesh']} on a shared card", fam, MESH_SHARED_CARD_SCANS, (B, N, K))
        count(("float64", B, N), sum(s[name]["sinkhorn_launches"] for s in shared))
        _credit_ranks(f"mesh {fam['mesh']} on a shared card", [s[name] for s in shared])
        d = float(np.abs(fam["pose"] - fam["plain_pose"]).max())
        if not np.all(np.isfinite(fam["pose"])) or not d <= MESH_POSE_BOUND_M:
            fail(f"mesh {fam['mesh']} on a shared card: max |d pose| {d:.3e} from run_sweep (bound {MESH_POSE_BOUND_M})")
        if not np.array_equal(shared[1][name]["pose"], fam["pose"]):
            fail(f"mesh {fam['mesh']} on a shared card: the ranks gathered different poses")
        bit_equal = bool(np.array_equal(fam["pose"], fam["plain_pose"]))
        print(f"mesh {fam['mesh']} on 2 gloo ranks sharing the card: {R} runs x {MESH_SHARED_CARD_SCANS} scans, "
              f"max |d pose| {d:.3e} from run_sweep (bit-equal {bit_equal}); {fam['ms_per_scan_cold']:.2f} ms/scan "
              f"cold; sinkhorn on {(B, N, K)}; collectives/scan {_collectives_per_scan(fam)}")
        record["shared_card"][name] = {"mesh": fam["mesh"], "max_abs_dpose": d, "bit_equal": bit_equal,
                                       "ms_per_scan_cold": fam["ms_per_scan_cold"],
                                       "collectives": fam["collectives"], "sinkhorn_shape": [B, N, K]}
    print(f"[mesh on one card: {time.perf_counter() - t_phase:.1f} s into phase 15]")

    if n_cards < 2:
        return record, launches
    if SWEEP_RUNS % n_cards:
        fail(f"mesh: {n_cards} cards do not divide the {SWEEP_RUNS} runs")
    worlds = [generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS, seed=s), device=device)
              for s in range(SWEEP_RUNS)]

    def one_card_sweep():
        """All SWEEP_RUNS runs on card 0 without a mesh (phase 14's main
        path): MESH_WARMUP scans, then the timed rest; (poses, ms/scan)."""
        runs = [w.batches for w in worlds]
        states, warm, _ = sweep.run_sweep([r[:MESH_WARMUP] for r in runs], PipelineConfig(), device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, rest, _ = sweep.run_sweep([r[MESH_WARMUP:] for r in runs], PipelineConfig(), states=states, device=device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / (N_SCANS - MESH_WARMUP)
        return torch.cat([warm.pose, rest.pose], dim=1).cpu().numpy(), ms

    # one card at R = SWEEP_RUNS before and after the families (in turns, in one call)
    one_poses, one_ms_before = one_card_sweep()
    if sweep_poses is None:  # phase 14 did not run: the same path here is the reference
        sweep_poses = one_poses
    ref_ate = [compute_ate(p, w.gt_poses, align="initial")["translation"]["rmse"] for p, w in zip(sweep_poses, worlds)]
    t0 = time.perf_counter()
    ranks = mesh_mod.run_ranks(mesh_cards_rank, n_cards, "cuda", n_cards, timeout=MESH_TIMEOUT_S)
    print(f"mesh: {n_cards} NCCL ranks ran three families in {time.perf_counter() - t0:.1f} s (with their start)")
    _, one_ms_after = one_card_sweep()
    print(f"mesh: one card without a mesh at R = {SWEEP_RUNS}: {one_ms_before:.2f} ms/scan before the families, "
          f"{one_ms_after:.2f} after ({N_SCANS - MESH_WARMUP} scans after {MESH_WARMUP})")
    record["one_card_r8_ms_per_scan_before_after"] = [one_ms_before, one_ms_after]
    record["families"] = {}
    for name in ("run", "hyp", "map"):
        fam = ranks[0][name]
        n_run = fam["mesh"]["run"]
        R_l = SWEEP_RUNS // n_run
        B = R_l * (C.K_HYP // fam["mesh"]["hyp"] if name == "hyp" else 1)
        for r, rank in enumerate(ranks):
            _sinkhorn_check(f"{fam['mesh']} rank {r}", rank[name], N_SCANS, (B, N, K))
            if not np.array_equal(rank[name]["pose"], fam["pose"]):
                fail(f"mesh {fam['mesh']}: rank {r} gathered other poses than rank 0")
        count(("float64", B, N), sum(rank[name]["sinkhorn_launches"] for rank in ranks))
        _credit_ranks(f"mesh {fam['mesh']}", [rank[name] for rank in ranks])
        poses = fam["pose"]
        if poses.shape != (SWEEP_RUNS, N_SCANS, 6) or not np.all(np.isfinite(poses)):
            fail(f"mesh {fam['mesh']}: poses of shape {poses.shape}, or non-finite")
        # each rank's block of runs against run_sweep of that block without a mesh, at the family's config
        d_ref = 0.0
        for r, rank in enumerate(ranks):
            lo, hi = rank[name]["ref_block"]
            mine, ref = poses[lo:hi, :MESH_REF_SCANS], rank[name]["ref_pose"]
            if name == "run" and not np.array_equal(mine, ref):
                fail(f"mesh {fam['mesh']}: runs {lo}-{hi - 1} differ from run_sweep of rank {r}'s block by "
                     f"{np.abs(mine - ref).max():.3e} (the same shapes: bit-equal expected)")
            d_ref = max(d_ref, float(np.abs(mine - ref).max()))
        if not d_ref <= MESH_POSE_BOUND_M:
            fail(f"mesh {fam['mesh']}: max |d pose| {d_ref:.3e} from run_sweep of each rank's block (bound "
                 f"{MESH_POSE_BOUND_M})")
        ates = [compute_ate(p, w.gt_poses, align="initial") for p, w in zip(poses, worlds)]
        for r, ate in enumerate(ates):
            trans, rot = ate["translation"]["rmse"], ate["rotation_deg"]["rmse"]
            if trans > GATE_ATE_TRANS_RMSE_M or rot > GATE_ATE_ROT_RMSE_DEG:
                fail(f"mesh {fam['mesh']} run {r} ATE gate: {trans:.4f} m / {rot:.4f} deg")
        d_ate = [abs(a["translation"]["rmse"] - b) for a, b in zip(ates, ref_ate)]
        bound_m = PER_HYP_ATE_BOUND_M if name == "hyp" else MESH_ATE_BOUND_M
        if max(d_ate) > bound_m:
            fail(f"mesh {fam['mesh']}: a run's ATE {max(d_ate):.3e} m from phase 14's (bound {bound_m})")
        ms = [rank[name]["ms_per_scan"] for rank in ranks]
        per_scan = _collectives_per_scan(fam, n_sweeps=2)
        print(f"mesh {fam['mesh']} on {n_cards} NCCL ranks{' (per hypothesis)' if name == 'hyp' else ''}: "
              f"{SWEEP_RUNS} flagship runs x {N_SCANS} scans, max |d pose| {d_ref:.3e} over the first {MESH_REF_SCANS} "
              f"from run_sweep of each rank's block of runs; {ms[0]:.2f} ms/scan (rank 0; slowest rank "
              f"{max(ms):.2f}) over {N_SCANS - MESH_WARMUP} scans after {MESH_WARMUP}, {fam['ms_per_scan_cold']:.2f} "
              f"cold; ATE per run {', '.join('%.4f' % a['translation']['rmse'] for a in ates)} m (max "
              f"{max(a['rotation_deg']['rmse'] for a in ates):.3f} deg), max |d ATE| from phase 14 {max(d_ate):.3e} m; "
              f"{fam['sinkhorn_launches'] / N_SCANS:.0f} sinkhorn launches/scan per rank on {(B, N, K)}; "
              f"collectives/scan {per_scan}; profile (rank 0, {MESH_PROFILE_SCANS} scans): "
              f"{fmt_profile(fam['profile'])} "
              f"[{time.perf_counter() - t_phase:.1f} s into phase 15]")
        record["families"][name] = {
            "mesh": fam["mesh"], "ms_per_scan_rank0": ms[0], "ms_per_scan_slowest_rank": max(ms),
            "ms_per_scan_cold": fam["ms_per_scan_cold"], "collectives_per_scan": per_scan,
            "sinkhorn_shape": [B, N, K], "sinkhorn_launches_per_rank": fam["sinkhorn_launches"],
            "ate_m": [a["translation"]["rmse"] for a in ates], "ate_deg": [a["rotation_deg"]["rmse"] for a in ates],
            "max_abs_d_ate_vs_phase14_m": max(d_ate), "max_abs_dpose_vs_block_run_sweep": d_ref,
            "block_ref_scans": MESH_REF_SCANS, "final_pose_spread_m": fam["final_pose_spread_m"],
            "profile_rank0": fam["profile"], "profiled_scans": MESH_PROFILE_SCANS}
    return record, launches


def run_tool(name: str, argv):
    """tools/<name>.main(argv) in this process, its output captured:
    (stdout, seconds). Fails unless it exits 0 (a main that returns None or
    its report exits 0)."""
    import importlib
    import io

    mod = importlib.import_module(f"gcslam_torch.tools.{name}")
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(list(argv))
    except SystemExit as e:
        rc = e.code
    seconds = time.perf_counter() - t0
    rc = 0 if rc is None or isinstance(rc, dict) else rc
    if rc != 0:
        fail(f"tools/{name} {' '.join(argv)}: exit {rc}; stderr: {err.getvalue()[-2000:]}")
    return out.getvalue(), seconds


def max_diff(a, b, path=""):
    """Largest |a - b| over the numbers of two JSON reports: 0 where both
    are the same non-finite value (NaN with NaN), inf where only one is
    finite or they are unequal infinities; fails where their structure,
    keys or other values differ."""
    if isinstance(a, dict):
        if list(a) != list(b):
            fail(f"card and CPU reports differ at {path}: keys {list(a)} vs {list(b)}")
        return max([max_diff(a[k], b[k], f"{path}.{k}") for k in a], default=0.0)
    if isinstance(a, list):
        if len(a) != len(b):
            fail(f"card and CPU reports differ at {path}: {len(a)} vs {len(b)} entries")
        return max([max_diff(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))], default=0.0)
    if isinstance(a, float) or isinstance(b, float):
        x, y = float(a), float(b)
        if x == y or (math.isnan(x) and math.isnan(y)):
            return 0.0
        return abs(x - y) if math.isfinite(x) and math.isfinite(y) else math.inf
    if a != b:
        fail(f"card and CPU reports differ at {path}: {a!r} vs {b!r}")
    return 0.0


@contextlib.contextmanager
def recorded_evidence(store: list):
    """Appends (operator, outputs as float64 numpy) for every call of the
    two evidence operators that diagnose_gyro_composition probes (it
    imports them at each call), unrounded, while the block runs."""
    from gcslam_torch.ops import evidence_imu, evidence_odom

    ops = [(evidence_imu, "imu_gyro_rotation_evidence", 3), (evidence_odom, "odom_quadratic_evidence", 2)]
    originals = [getattr(mod, name) for mod, name, _ in ops]  # outputs: (L, h, r_rot) and (L, h)

    def recording(fn, name, n_out):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.append((name, [o.detach().cpu().double().numpy() for o in out[:n_out]]))
            return out
        return call

    for (mod, name, n_out), fn in zip(ops, originals):
        setattr(mod, name, recording(fn, name, n_out))
    try:
        yield store
    finally:
        for (mod, name, _), fn in zip(ops, originals):
            setattr(mod, name, fn)


def phase_tools():
    """The 26 tools on phase 11's Kimera-schema bag, its ground truth and
    its eval.run output, each through its main() in this process (one
    through `python3 -m` in a child): the Kimera-ready preparation flow,
    the forensics, the trajectory and map-event tools, and the three device
    tools on the card against --cpu. Returns its record."""
    import shutil

    from gcslam_torch.frontend import rosbag

    t_phase = time.perf_counter()
    bag_dir = os.path.join(OUT_DIR, "bag")
    bag, gt = os.path.join(bag_dir, "kimera_synth.db3"), os.path.join(bag_dir, "kimera_synth_gt.tum")
    run_dir = os.path.join(bag_dir, "run")
    traj, events = os.path.join(run_dir, "trajectory.tum"), os.path.join(run_dir, "map_events.jsonl")
    out = os.path.join(OUT_DIR, "tools")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "time_alignment"))
    summary = rosbag.bag_topic_summary(bag)

    def topic(frag):
        return next(n for n, (typ, count) in summary.items() if frag in typ and count)

    lidar, imu, odom = topic("PointCloud2"), topic("Imu"), topic("Odometry")
    seconds = {}

    def tool(name, *argv, label=None):
        text, s = run_tool(name, argv)
        seconds[label or name] = s
        return text

    # 1. bag preparation: README's Kimera-ready flow into a copy of the config
    cfg = rosbag.bag_config_from_file(BAG_CONFIG)
    cfg_copy = os.path.join(out, os.path.basename(BAG_CONFIG))
    shutil.copy(BAG_CONFIG, cfg_copy)
    profile = os.path.join(out, "time_alignment", "kimera_10_14_acl_jackal_005.yaml")  # the path the config names
    tool("compute_time_alignment", bag, "--reference", lidar, "--topics", imu, odom, "--out", profile)

    def T(v):
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = rosbag._rotvec_R(v[3:6]), v[:3]
        return m.tolist()

    ext = os.path.join(out, "extrinsics.yaml")
    with open(ext, "w") as f:
        json.dump({"transforms": [{"name": "T_baselink_lidar", "T": T(cfg.T_base_lidar)},
                                  {"name": "T_cameralink_gyro", "T": T(cfg.T_base_imu)}]}, f)
    tool("kimera_calibration_to_gc", ext, "--apply", "--config", cfg_copy)
    prepared = rosbag.bag_config_from_file(cfg_copy)
    ext_err = max(float(np.abs(np.subtract(getattr(prepared, k), getattr(cfg, k))).max())
                  for k in ("T_base_lidar", "T_base_imu"))
    offsets = {k: a.offset_sec for k, a in (prepared.alignment or {}).items()}
    if set(offsets) != {imu, odom} or not np.isfinite(list(offsets.values())).all():
        fail(f"tools: the time-alignment profile read back through the config holds {offsets}")
    if ext_err > 1e-6:
        fail(f"tools: kimera_calibration_to_gc's extrinsics are {ext_err:.2e} from the config's")
    tool("dump_raw_imu_odom", bag, "--out-dir", out)
    rotvec = ",".join(str(x) for x in cfg.T_base_imu[3:6])
    tool("apply_imu_extrinsic", os.path.join(out, "imu_raw_first_300.csv"), f"--rotvec={rotvec}", "--out",
         os.path.join(out, "imu_base.csv"))
    tool("validate_conventions", bag, "--json", f"--t-base-imu={rotvec}")

    # 2. forensics on cdr / rosbag alone; bag_info also as a module in a child
    info = json.loads(tool("bag_info", bag))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-m", "gcslam_torch.tools.bag_info", bag], capture_output=True,
                           text=True, timeout=120)
    seconds["bag_info (python3 -m)"] = time.perf_counter() - t0
    if child.returncode != 0 or json.loads(child.stdout) != info:
        fail(f"tools: python3 -m gcslam_torch.tools.bag_info exited {child.returncode} or printed another report; "
             f"stderr: {child.stderr[-2000:]}")
    tool("first_n_messages_summary", bag, "--json", os.path.join(out, "first_messages.json"))
    tool("inspect_bag_deep", bag, "--json", os.path.join(out, "inspect_bag_deep.json"))
    tool("inspect_odom_covariance", bag, "--json")
    tool("inspect_odom_source", bag, "--json")
    cam = json.loads(tool("inspect_camera_frames", bag, "--json"))
    if "rgb_depth_pairing" not in cam:
        fail(f"tools: inspect_camera_frames paired no rgb and depth frames on {sorted(cam['topics'])}")
    tool("plot_wz_odom", os.path.join(out, "odom_raw_first_300.csv"), "--out", os.path.join(out, "wz.svg"))
    tool("compare_accel_odom", bag, "--config", BAG_CONFIG, "--json")
    tool("compare_imu_sources", bag, "--json")
    tool("check_extrinsics", BAG_CONFIG, "--bag", bag, "--json")
    tool("check_lidar_mount_angle", bag, "--json")
    tool("check_turn_invariant", bag, "--config", BAG_CONFIG, "--json")
    tool("diagnose_frames", bag, "--json")
    tool("diagnose_trajectory_axes", bag, traj, "--json")

    # 3. the trajectory and the map-event log of phase 11's eval.run
    tool("evaluate_trajectory_2d", traj, gt, "--plot", os.path.join(out, "trajectory_2d.svg"), "--json")
    tool("diagnose_trajectory_alignment", traj, gt, "--json")
    swaps = json.loads(tool("trajectory_swaps", traj, gt, "--top", "3"))
    if not swaps["identity_is_best"]:
        fail(f"tools: trajectory_swaps ranks {swaps['best']['perm']} above the identity")
    n_scans = sum(1 for line in open(events) if "event" not in json.loads(line))
    rep = json.loads(tool("replay_map_events", events, "--at-scan", str(n_scans - 1), "--snapshot",
                          os.path.join(out, "map_snapshot.npz"), "--json"))
    if rep["n_scans"] != n_scans or n_scans != BAG_SYNTH["n_scans"] or not all(rep["integrity"].values()):
        fail(f"tools: replay_map_events over {rep['n_scans']} of {BAG_SYNTH['n_scans']} scans: {rep['integrity']}")
    with np.load(os.path.join(out, "map_snapshot.npz")) as z:
        if len(z["ids"]) != rep["n_inserts"]:
            fail(f"tools: the map snapshot holds {len(z['ids'])} of {rep['n_inserts']} inserts")

    # 4. the device tools on the card and with --cpu
    card_cpu = {}
    for name, argv, tol in (("dead_reckon", ["--bag", bag], TOOLS_CARD_CPU_TOL),
                            ("estimate_extrinsics", ["--bag", bag], TOOLS_CARD_CPU_TOL),
                            ("diagnose_gyro_composition", ["--json"], GYRO_CARD_CPU_TOL)):
        with recorded_evidence([]) as ev_card:
            card = json.loads(tool(name, *argv))
        with recorded_evidence([]) as ev_cpu:
            cpu = json.loads(tool(name, *argv, "--cpu", label=f"{name} --cpu"))
        d = max_diff(card, cpu)
        card_cpu[name] = {"max_abs_diff": d, "bit_equal": card == cpu}
        if d > tol:
            fail(f"tools/{name}: the card's report is {d:.3e} from the CPU's (bound {tol})")
    gyro = card
    if gyro["verdict"] != "OK":
        fail(f"tools/diagnose_gyro_composition on the card: verdict {gyro['verdict']}")
    # the gyro report's rounding hides gaps under ~1e-4 deg: hold the
    # operators' unrounded outputs at every probe as well
    calls = [name for name, _ in ev_card]
    if calls != [name for name, _ in ev_cpu] or calls.count("odom_quadratic_evidence") != 1 or len(calls) != 4:
        fail(f"tools/diagnose_gyro_composition called the evidence operators as {calls} on the card, "
             f"{[name for name, _ in ev_cpu]} with --cpu")
    ev_rel = max(max_diff(a.tolist(), b.tolist()) / max(1.0, float(np.abs(b).max()))
                 for (_, outs_card), (_, outs_cpu) in zip(ev_card, ev_cpu) for a, b in zip(outs_card, outs_cpu))
    card_cpu[name]["evidence_max_rel_diff"] = ev_rel
    if not ev_rel <= GYRO_EVIDENCE_RTOL:
        fail(f"tools/diagnose_gyro_composition: the evidence operators' outputs on the card are {ev_rel:.3e} "
             f"(relative) from the CPU's (bound {GYRO_EVIDENCE_RTOL})")

    phase_s = time.perf_counter() - t_phase
    print(f"tools on phase 11's bag: {len(seconds)} runs of {len({k.split()[0] for k in seconds})} tools in "
          f"{phase_s:.1f} s; the prepared config's extrinsics {ext_err:.1e} from the config's, alignment offsets "
          f"{ {k: round(v, 6) for k, v in offsets.items()} } s; map events: {rep['n_inserts']} inserts over "
          f"{n_scans} scans, integrity {rep['integrity']}; trajectory_swaps best {swaps['best']['perm']} "
          f"(ATE {swaps['best']['ate_trans_rmse_m']} m); card vs --cpu {card_cpu}; gyro verdict {gyro['verdict']}")
    print("tool seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    if phase_s > TOOLS_PHASE_LIMIT_S:
        fail(f"tools: phase 16 took {phase_s:.1f} s (limit {TOOLS_PHASE_LIMIT_S} s)")
    return {"seconds": phase_s, "tool_seconds": seconds, "n_tools": len({k.split()[0] for k in seconds}),
            "extrinsics_round_trip_err": ext_err, "alignment_offsets_s": offsets,
            "map_events": {"n_scans": n_scans, "n_inserts": rep["n_inserts"], "integrity": rep["integrity"]},
            "swaps_best": swaps["best"], "card_vs_cpu": card_cpu, "gyro_verdict": gyro["verdict"]}


def f32_flagship_child() -> None:
    """Phase 13's child (GCSLAM_BELIEF_DTYPE=float32 binds at import): the
    flagship replay after a warm-up; prints one JSON line. The Sinkhorn
    calls are the (dtype, (N, K)) of its launches and the eigh launches by
    instance, from the launch counters (credited at each graph replay), and
    so the Lie-group launches; the first input of each eigh instance goes
    to F32_EIGH_INPUTS, the first operands of each Lie-group instance to
    F32_LIE_INPUTS."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.ops import eigh, se3, sinkhorn
    from gcslam_torch.tools.precision_compare import certificate_fields
    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    EIGH_SEEN.install()
    LIE_SEEN.install()
    run = generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS))
    cfg = PipelineConfig()
    runner.run_bag(run.batches[:N_WARMUP], cfg)
    torch.cuda.synchronize()
    for counter in [sinkhorn.COUNTER, se3.LIE_COUNTER] + list(eigen_counters().values()):
        counter.reset()
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / N_SCANS
    poses = out.pose.double().cpu().numpy()
    ate = compute_ate(poses, run.gt_poses, align="initial")
    calls = sorted({(dt, shape[1:] if shape[0] == 1 else shape) for dt, shape in sinkhorn.COUNTER.by_instance})
    eigh_launches = [[name, dt, list(shape), n] for name, counter in eigen_counters().items()
                     for (dt, shape), n in sorted(counter.by_instance.items())]
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(F32_EIGH_INPUTS, **EIGH_SEEN.host())
    np.savez(F32_LIE_INPUTS, **LIE_SEEN.host())
    print(json.dumps({"belief_dtype": str(BELIEF_DTYPE), "pose_dtype": str(out.pose.dtype), "ms_per_scan": ms,
                      "sinkhorn_launches": sinkhorn.COUNTER.launches, "sinkhorn_calls": calls,
                      "eigh_launches": eigh_launches,
                      "lie_launches": [[op, dt, list(b), n] for (op, dt, b), n in sorted(lie_counts().items())],
                      "finite": bool(np.isfinite(poses).all()), "ate_m": ate["translation"]["rmse"],
                      "ate_deg": ate["rotation_deg"]["rmse"], **certificate_fields(out.tape)}))


def phase_f32(out_flag, ate_flag, ms_flag):
    """The f32-belief flagship in a child process; returns its record and
    its Sinkhorn launches (all of the f32 instance). Its eigh launches are
    credited and its Lie-group launches join LIE_LAUNCHES; its eigh inputs
    join EIGH_SEEN, its Lie-group operands LIE_SEEN."""
    from gcslam_torch.tools.precision_compare import certificate_fields

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **F32_ENV, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.f32_flagship_child()"], cwd=root,
                          env=env, capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"f32 flagship: the child exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    f64 = certificate_fields(out_flag.tape)
    print(f"f32-belief flagship ({N_SCANS} scans, child process {child_s:.1f} s): {r['ms_per_scan']:.2f} ms/scan "
          f"(f64, phase 3: {ms_flag:.2f}); ATE {r['ate_m']:.4f} m / {r['ate_deg']:.4f} deg (f64: "
          f"{ate_flag['translation']['rmse']:.4f} / {ate_flag['rotation_deg']['rmse']:.4f}); sinkhorn launches "
          f"{r['sinkhorn_launches']} on {r['sinkhorn_calls']}")
    for key in f64:
        print(f"  {key}: f32 {r[key]:.6g}, f64 {f64[key]:.6g}")
    want = [["float32", [1024, 8]]]
    if r["belief_dtype"] != "torch.float32" or r["pose_dtype"] != "torch.float32" or not r["finite"]:
        fail(f"f32 flagship: belief {r['belief_dtype']}, poses {r['pose_dtype']}, finite {r['finite']}")
    if r["sinkhorn_launches"] != 2 * N_SCANS or r["sinkhorn_calls"] != want:
        fail(f"f32 flagship: {r['sinkhorn_launches']} launches on {r['sinkhorn_calls']}, expected {2 * N_SCANS} "
             f"on {want}")
    if r["ate_m"] > GATE_ATE_TRANS_RMSE_M or r["ate_deg"] > GATE_ATE_ROT_RMSE_DEG:
        fail(f"f32 flagship ATE gate: {r['ate_m']:.4f} m / {r['ate_deg']:.4f} deg")
    eigh_credit("f32-belief flagship", {(name, dt, tuple(shape)): n for name, dt, shape, n in r["eigh_launches"]})
    with np.load(os.path.join(root, F32_EIGH_INPUTS)) as z:
        EIGH_SEEN.merge(dict(z), "cuda")
    LIE_LAUNCHES.update({(op, dt, tuple(batch)): n for op, dt, batch, n in r["lie_launches"]})
    with np.load(os.path.join(root, F32_LIE_INPUTS)) as z:
        LIE_SEEN.merge(dict(z), "cuda")
    return {**r, "child_s": child_s, "f64_certificates": f64}, r["sinkhorn_launches"]


def phase_runtime(device, run, ledger_flag, launches_phase8):
    """Phase 17: the measurement layer on the card at the flagship
    PipelineConfig(): warm_cache, cold_start in a fresh child, phase 3's
    transfer ledger, the implicit host syncs a scan, profile_step, the
    kernel census of one scan against phase 8's launch calls a scan, and
    the scatter strategies; returns its record."""
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.tools import cold_start, kernel_census, microbench_scatter, profile_step, warm_cache
    from gcslam_torch.utils.cuda_profile import implicit_syncs
    from gcslam_torch.utils.profiling import COUNTERS

    t_phase = time.perf_counter()
    rec = {}

    builds = COUNTERS.native_builds
    out, _ = run_tool("warm_cache", [])
    warm = json.loads(out.strip().splitlines()[-1])
    if not all(lib["already_built"] for lib in warm["libraries"].values()) or warm["native_builds"] != builds:
        fail(f"warm_cache: a library was not built by phase 1, or warm_cache built one: {warm}")
    print("warm_cache: " + ", ".join(f"{k} already built {v['already_built']}, loaded in {v['s']:.3f} s"
                                     for k, v in warm["libraries"].items())
          + f"; flagship step {warm['step_s']:.3f} s, one chunk of {warm['chunk']} scans {warm['chunked_s']:.3f} s")
    rec["warm_cache"] = warm

    cold = cold_start.measure(cpu=False, skip_warm=True)
    milestones = [cold.get(k) for k in ("import_done", "data_ready", "first_pose_s", "chunk_pose_s")]
    if cold["rc"] != 0 or None in milestones or milestones != sorted(milestones) or cold["native_builds"] != 0:
        fail(f"cold_start: {cold}")
    print(f"cold_start (fresh process, after phase 1's build): import {cold['import_done']:.2f} s, data "
          f"{cold['data_ready']:.2f} s, first pose {cold['first_pose_s']:.2f} s, chunk of {cold_start.N_SCANS} "
          f"{cold['chunk_pose_s']:.2f} s, process wall {cold['fresh_process_wall_s']:.2f} s; native builds before "
          f"the first pose {cold['native_builds']}")
    rec["cold_start"] = cold

    print(f"transfer ledger of phase 3's {N_SCANS}-scan run_bag before the gather: {ledger_flag['h2d_calls']} "
          f"host-to-device call of {ledger_flag['h2d_bytes']} B, {ledger_flag['d2h_bytes']} B read back, "
          f"{ledger_flag['host_syncs']} host syncs (the batches lie on the card: the commit stacks them there)")
    rec["ledger_flagship"] = ledger_flag

    cfg = PipelineConfig()
    state, _ = runner.run_bag(run.batches[:N_WARMUP], cfg, device=device)
    sites = implicit_syncs(lambda: runner.eager_steps(state, run.batches[N_WARMUP:N_WARMUP + N_PROFILE_SCANS], cfg))
    n_sync = sum(sites.values())
    print(f"implicit host syncs over {N_PROFILE_SCANS} eager flagship scans (set_sync_debug_mode('warn')): {n_sync} "
          f"({n_sync / N_PROFILE_SCANS:.1f} a scan) at " + ", ".join(f"{k} x{v}" for k, v in sites.most_common()))
    rec["implicit_syncs"] = {"n_scans": N_PROFILE_SCANS, "total": n_sync, "sites": dict(sites.most_common())}

    out, _ = run_tool("profile_step", ["--steps", str(PROFILE_STEPS)])
    prof = json.loads(out)
    if not prof["finite"] or prof["timing"]["n"] != PROFILE_STEPS:
        fail(f"profile_step: {prof}")
    print(f"profile_step over {PROFILE_STEPS} steps: p50 {prof['timing']['p50_ms']:.2f} ms, p95 "
          f"{prof['timing']['p95_ms']:.2f} ms, peak {prof['compute']['peak_allocated_bytes'] / 2**20:.1f} MiB "
          f"({prof['compute']['peak_above_start_bytes'] / 2**20:.1f} MiB above the step's start), first scan "
          f"{prof['first_scan_s']:.3f} s, matmul FLOPs {prof['compute']['matmul_flops']}; top kernels "
          + ", ".join(f"{kernel_census.family(k)} x{v}" for k, v in list(prof["top_kernels"].items())[:5]))
    rec["profile_step"] = prof

    census_path = os.path.join(OUT_DIR, "kernel_census.json")
    run_tool("kernel_census", ["--scans", str(N_WARMUP + 1), "--json", census_path])
    census = json.load(open(census_path))
    total = census["launch_calls_per_scan"]
    d = abs(total - launches_phase8) / launches_phase8
    print(f"kernel_census of scan {N_WARMUP} (after {N_WARMUP}): {total} launch calls ({d:.2%} from phase 8's "
          f"{launches_phase8:.0f} a scan), {census['attributed_launches']} attributed, {census['aten_ops']} aten ops, "
          f"{census['device_kernels_per_scan']} device kernels, {census['d2d_copies']} device-to-device copies of "
          f"{census['d2d_copy_bytes']} B, {census['scalar_output_launches']} launches with 0-d outputs, "
          f"census {census['census_s']:.1f} s; top functions by launches: "
          + "; ".join(f"{r['function']} {r['launches']} ({r['device_us']:.0f} us)" for r in census["top_functions"]))
    if d > CENSUS_LAUNCH_RTOL or census["attributed_launches"] != total:
        fail(f"kernel_census: {total} launch calls ({census['attributed_launches']} attributed) against phase 8's "
             f"{launches_phase8:.0f} (bound {CENSUS_LAUNCH_RTOL:.0%})")
    rec["kernel_census"] = {k: v for k, v in census.items() if k != "top_functions"}
    rec["kernel_census"]["top_functions"] = census["top_functions"]

    scatter = microbench_scatter.run(device)
    groups = {}
    for r in scatter:
        groups.setdefault("surfel" if "surfel" in r["name"] else "fuse", []).append(r["checksum"])
    spread = {g: max(v) - min(v) for g, v in groups.items()}
    print("microbench_scatter (CUDA events, 20 calls): " + ", ".join(
        f"{r['name']} {r['ms']:.4f} ms (checksum {r['checksum']:.4f})" for r in scatter)
        + f"; checksum spread fuse {spread['fuse']:.2e}, surfel {spread['surfel']:.2e}")
    if max(spread.values()) > SCATTER_CHECKSUM_TOL:
        fail(f"microbench_scatter: checksums disagree by {spread} (tolerance {SCATTER_CHECKSUM_TOL})")
    rec["microbench_scatter"] = [{k: r[k] for k in ("name", "ms", "checksum")} for r in scatter]
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[runtime tools: {rec['seconds']:.1f} s in phase 17]")
    return rec


def compare_routes(ref, got) -> dict:
    """One scan's pose and tape on the kernel routes against the plain
    routes, at tests/test_torch_slice.py's tolerances; returns the max |d|
    of each field that is not equal."""
    import numpy as np

    diffs = {}
    d_pose = float((got.pose - ref.pose).abs().max())
    if d_pose:
        diffs["pose"] = d_pose
    if d_pose > ROUTE_POSE_ATOL:
        fail(f"compiled step: kernel and plain routes' poses apart by {d_pose:.3e} (bound {ROUTE_POSE_ATOL})")
    degenerate = bool(ref.tape.ot_transport_mass < 1e-9)  # one scan: its mass-gated fields are not compared
    for f in ref.tape._fields:
        r = getattr(ref.tape, f).cpu().numpy().astype(np.float64)
        g = getattr(got.tape, f).cpu().numpy().astype(np.float64)
        if r.size and not np.array_equal(r, g):
            diffs[f] = float(np.abs(g - r).max())
        if f in ROUTE_EXACT:
            ok = np.array_equal(r, g)
        elif f in ROUTE_MASS_GATED and degenerate:
            ok = True
        else:
            rtol, atol = ROUTE_TOL.get(f, ROUTE_DEFAULT_TOL)
            ok = not r.size or np.abs(g - r).max() <= rtol * np.abs(r).max() + atol
        if not ok:
            fail(f"compiled step: tape field {f} apart between the kernel and plain routes by {diffs.get(f)}")
    return diffs


@contextlib.contextmanager
def plain_routes():
    """Every kernel of the step on its plain version: the Sinkhorn loop, the
    3 x 3 Jacobi chain (and the 3 x 3 projection's torch epilogue) and the
    fixed-sweep Jacobi in plain torch."""
    from gcslam_torch.ops import association, eigh, sinkhorn

    saved = association.sinkhorn_unbalanced, eigh.eigh3, eigh.psd3, eigh.eigh_sym
    association.sinkhorn_unbalanced = sinkhorn.sinkhorn_unbalanced_reference
    eigh.eigh3, eigh.psd3, eigh.eigh_sym = eigh.eigh3_reference, eigh.psd3_reference, eigh.eigh_sym_reference
    try:
        yield
    finally:
        association.sinkhorn_unbalanced, eigh.eigh3, eigh.psd3, eigh.eigh_sym = saved


def phase_compiled(device, run=None, out_flag=None):
    """Phase 18: the compiled step (models/runner.CompiledStep) at
    PipelineConfig(); returns its record."""
    import torch
    from gcslam_torch.eval.ate_rpe import compute_ate
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_step import scan_step
    from gcslam_torch.ops import eigh, sinkhorn
    from gcslam_torch.utils import cuda_profile
    from gcslam_torch.utils.profiling import COUNTERS

    t_phase = time.perf_counter()
    if run is None:
        run = generate(SyntheticConfig(n_scans=N_SCANS, n_points=N_POINTS), device=device)
    cfg = PipelineConfig()
    rec = {}

    # the capture: a fresh compiled step, its first scan eager on a side stream
    runner.release_graphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = runner.run_bag(run.batches[:N_WARMUP], cfg, device=device)
    torch.cuda.synchronize()
    step = runner.compiled_steps()[-1]
    rec["capture_s"], rec["first_run_s"] = step.capture_s, time.perf_counter() - t0
    print(f"compiled step: capture and instantiation {step.capture_s:.3f} s; the first run_bag ({N_WARMUP} scans: "
          f"scan 0 eager on a side stream, the capture, {step.replays} replays) {rec['first_run_s']:.3f} s")

    # no implicit host sync in three eager flagship scans
    with torch.no_grad():
        s = state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for b in run.batches[N_WARMUP:N_WARMUP + N_SYNC_SCANS]:
                s, _ = scan_step(s, b, cfg)
        except RuntimeError as e:
            fail(f"an eager flagship scan synchronized with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print(f"compiled step: {N_SYNC_SCANS} eager flagship scans under set_sync_debug_mode('error'): 0 implicit syncs")
    rec["implicit_syncs_eager"] = 0

    # the 50-scan flagship through the graph against the eager step
    sinkhorn.COUNTER.reset()
    COUNTERS.reset()
    with eigh_counted("compiled-step flagship (phase 18)"):
        state_g, out_g = runner.run_bag(run.batches, cfg, device=device)
    ledger = COUNTERS.cert()
    launches = sinkhorn.COUNTER.launches
    eigh_launches = eigh_counts()
    torch.cuda.synchronize()
    state_e, out_e = runner.eager_steps(runner.init_state(cfg, device=device), run.batches, cfg)
    equal = torch.equal(out_g.pose, out_e.pose)
    d_pose = float((out_g.pose - out_e.pose).abs().max())
    tape_equal = all(torch.equal(getattr(out_g.tape, f), getattr(out_e.tape, f)) for f in out_g.tape._fields)
    ate = compute_ate(out_g.pose.cpu().numpy(), run.gt_poses, align="initial")
    ate_m, ate_deg = ate["translation"]["rmse"], ate["rotation_deg"]["rmse"]
    same_as_phase3 = None if out_flag is None else torch.equal(out_g.pose, out_flag.pose)
    per_scan = {k: v / N_SCANS for k, v in eigh_launches.items()}
    rec["eigh_launches_per_scan"] = {f"{k[0]} {k[1]} {k[2]}": v for k, v in sorted(per_scan.items())}
    print(f"compiled step: eigen launches a replayed scan: " + ", ".join(
        f"{name} {sum(v for k, v in per_scan.items() if k[0] == name):g}" for name in EIGEN_COUNTERS))
    print(f"compiled step, {N_SCANS} flagship scans: poses {'bit-equal' if equal else 'not bit-equal'} to the eager "
          f"step's (max |d| {d_pose:.3e}), tape {'bit-equal' if tape_equal else 'not bit-equal'}; ATE {ate_m:.4f} m "
          f"/ {ate_deg:.4f} deg; {launches} sinkhorn launches counted over the replays; transfer ledger "
          f"{ledger['h2d_calls']} / {ledger['d2h_bytes']} B / {ledger['host_syncs']}"
          + ("" if same_as_phase3 is None else f"; bit-equal to phase 3's run_bag: {same_as_phase3}"))
    if not torch.isfinite(out_g.pose).all():
        fail("compiled step: non-finite poses")
    if not equal:
        fail(f"compiled step: poses differ from the eager step's by {d_pose:.3e}")
    if launches != cfg.map_icp_iters * N_SCANS:
        fail(f"compiled step: {launches} sinkhorn launches over {N_SCANS} replays, expected {cfg.map_icp_iters * N_SCANS}")
    if (ledger["h2d_calls"], ledger["d2h_bytes"], ledger["host_syncs"]) != (1, 0, 0):
        fail(f"compiled step: transfer ledger {ledger}")
    if ate_m > GATE_ATE_TRANS_RMSE_M or ate_deg > GATE_ATE_ROT_RMSE_DEG:
        fail(f"compiled step ATE gate: {ate_m:.4f} m / {ate_deg:.4f} deg")
    rec.update(n_scans=N_SCANS, poses_bit_equal_to_eager=equal, max_abs_dpose=d_pose, tape_bit_equal=tape_equal,
               ate_m=ate_m, ate_deg=ate_deg, sinkhorn_launches=launches, ledger=ledger,
               bit_equal_to_phase3=same_as_phase3)

    # one scan on the plain routes against the kernel routes
    with torch.no_grad():
        s5, _ = runner.eager_steps(runner.init_state(cfg, device=device), run.batches[:N_WARMUP], cfg)
        _, out_k = scan_step(s5, run.batches[N_WARMUP], cfg)
        with plain_routes():
            _, out_p = scan_step(s5, run.batches[N_WARMUP], cfg)
        torch.cuda.synchronize()
    diffs = compare_routes(out_p, out_k)
    print(f"compiled step: scan {N_WARMUP} on the plain routes and on the kernels within tests/test_torch_slice.py's "
          f"tolerances; fields not bit-equal: " + (", ".join(f"{k} {v:.2e}" for k, v in sorted(diffs.items()))
                                                     or "none"))
    rec["plain_vs_kernel_routes"] = diffs

    # eager and graph ms/scan, interleaved
    span = run.batches[N_WARMUP:N_WARMUP + N_TIMED_SCANS]
    pairs = []
    for _ in range(N_TIMING_PAIRS):
        times = []
        for fn in (lambda: runner.eager_steps(state, span, cfg), lambda: runner.run_bag(span, cfg, state=state, device=device)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0) / len(span))
        pairs.append(times)
    print(f"compiled step: ms/scan over {N_TIMED_SCANS} scans in {N_TIMING_PAIRS} interleaved (eager, graph) pairs: "
          + ", ".join(f"({e:.2f}, {g:.2f})" for e, g in pairs))
    rec["ms_per_scan_pairs"] = pairs

    # the graph's kernels a replay, from torch.profiler: the launches the
    # counters credit over the replays against the kernels the device ran
    counted = {"sinkhorn_kernel": ("sinkhorn_kernel", sinkhorn.COUNTER)}
    counted.update({name: (EIGEN_TRACE[name], counter) for name, counter in eigen_counters().items()})
    for _, counter in counted.values():
        counter.reset()
    prof, span_ms = cuda_profile.profile(lambda: runner.run_bag(span[:N_PROFILE_SCANS], cfg, state=state,
                                                                device=device))
    ran = cuda_profile.kernel_counts(prof)
    raw = cuda_profile.raw_events(prof)
    credited = {k: c.launches for k, (_, c) in counted.items()}
    on_device = {k: sum(n for name, n in ran.items() if re.search(pat, name)) for k, (pat, _) in counted.items()}
    busy = cuda_profile.device_activity(raw)
    rec["kernel_device_ms_per_scan"] = {
        k: sum(e.duration_ns() for e in busy if re.search(pat, e.name())) / 1e6 / N_PROFILE_SCANS
        for k, (pat, _) in counted.items()}
    rec["profile"] = {"graph": cuda_profile.record(raw, span_ms, N_PROFILE_SCANS),
                      "eager": cuda_profile.profile_record(
                          lambda: runner.eager_steps(state, span[:N_PROFILE_SCANS], cfg), N_PROFILE_SCANS)}
    rec["replay_kernels_credited_vs_traced"] = {k: [credited[k], on_device[k]] for k in credited}
    print(f"compiled step: profile over {N_PROFILE_SCANS} scans: {fmt_profile(rec['profile'])}; kernels the "
          f"counters credit over the {N_PROFILE_SCANS} replays against the device's trace: "
          + ", ".join(f"{k} {credited[k]} / {on_device[k]}" for k in credited) + "; their device ms a replayed scan: "
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["kernel_device_ms_per_scan"].items()))
    if credited != on_device:
        fail(f"compiled step: the launch counters credit {credited} over {N_PROFILE_SCANS} replays, the device ran "
             f"{on_device}")
    eager_launches = rec["profile"]["eager"]["launch_calls_per_scan"]
    if eager_launches is None or eager_launches >= EAGER_LAUNCH_BOUND:
        fail(f"compiled step: the eager step makes {eager_launches} launch calls a scan (bound {EAGER_LAUNCH_BOUND})")
    if rec["profile"]["graph"]["graph_launches_per_scan"] != 1:
        fail(f"compiled step: {rec['profile']['graph']['graph_launches_per_scan']} graph launches a scan, expected 1")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def main(argv=None) -> None:
    import argparse

    import torch
    from gcslam_torch.ops import se3

    p = argparse.ArgumentParser(prog="python3 chip_smoke.py")
    p.add_argument("--phases", default=None,
                   help="1,2,15 or 1,2,18: the device, the kernels and the mesh or the compiled-step phase alone "
                        "(default: every phase)")
    args = p.parse_args(argv)
    full = args.phases is None
    alone = None if full else sorted({int(x) for x in args.phases.split(",")})
    if not full and alone not in ([1, 2, 15], [1, 2, 18]):
        fail("--phases takes 1,2,15 or 1,2,18 (phases 3-14, 16 and 17 run together, with no --phases)")

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"{torch.cuda.device_count()} card(s) visible")
    print(nvidia_smi_line())

    t_start = time.perf_counter()
    seconds = {}

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - t_start - sum(seconds.values())
        for key in LIE_SEEN.inputs:  # the Lie-group instances this phase launched first
            LIE_FIRST.setdefault(key, name)
        LIE_LAUNCHES.update(lie_counts())  # and this phase's launches, whatever reads the counter later
        se3.LIE_COUNTER.reset()
        print(f"[{name}: {seconds[name]:.1f} s; {time.perf_counter() - t_start:.1f} s since the start]", flush=True)

    # 2. kernels against their plain versions
    phase_build()
    sk = phase_sinkhorn(device)
    rs = phase_raster(device)
    eg, eigh_per_scan = phase_eigh(device)
    eigh_random = phase_eigh_random(device)
    lie, lie_per_scan = phase_lie(device)
    lap("phases 1-2")
    EIGH_SEEN.install()  # the first input of every eigh instance the paths launch
    LIE_SEEN.install()  # and the first operands of every Lie-group instance

    sinkhorn_launches, raster_launches, paths = {}, {}, {}
    sweep_poses = None
    if full:
        # 3-4. the flagship path and determinism
        run, cfg, out_flag, ms_flag, launches_flag, ate_flag, ledger_flag = phase_flagship(device)
        phase_determinism(device, run, cfg)
        lap("phases 3-4")

        # 5-7. the camera path, the render of its map, the viewer
        run_cam, state_cam, out_cam, ms_cam, fe_ms, launches_cam, ate_cam = phase_camera(device)
        launches_raster, renders, err_render = phase_render(device, state_cam, out_cam)
        phase_viewer(state_cam, out_cam, run_cam)
        lap("phases 5-7")

        # 8-10. the per-hypothesis map branch, the live modes, the filter options
        per_hyp, shared_ext, launches_hyp = phase_per_hypothesis(device, run, ate_flag)
        lap("phase 8")
        live, launches_live = phase_live(device, run, out_flag)
        lap("phase 9")
        options, launches_opt = phase_options(device, run)
        lap("phase 10")

        # 11. a Kimera-schema bag through eval.run
        bag, launches_bag = phase_bag(device, sk[("float64", 1, 512)])
        lap("phase 11")

        # 12. the rehearsal's canonical bag, camera on, through the full variant's command
        canon, launches_canon, launches_raster_canon = phase_canonical(device, sk[("float64", 1, 1024)],
                                                                       rs[(360, 480)])
        lap("phase 12")

        # 13. the f32-belief flagship
        f32, launches_f32 = phase_f32(out_flag, ate_flag, ms_flag)
        lap("phase 13")

        # 14. replay sweeps
        sweep_rec, launches_sweep, sweep_poses = phase_sweep(device, run, out_flag, ate_flag)
        lap("phase 14")

        sinkhorn_launches = {
            ("float64", 1, 1024): launches_flag + launches_live + launches_opt + launches_canon,
            ("float64", 4, 1024): launches_hyp,
            ("float64", 1, 1536): launches_cam,
            ("float64", 1, 512): launches_bag,
            ("float32", 1, 1024): launches_f32,
        }
        for key, n in launches_sweep.items():
            sinkhorn_launches[key] = sinkhorn_launches.get(key, 0) + n
        raster_launches = {(240, 320): launches_raster, (360, 480): VIEWER_RENDERS + launches_raster_canon}
        paths = {
            "flagship": {"ms_per_scan": ms_flag, "n_scans": N_SCANS, "n_points": N_POINTS,
                         "ate_m": ate_flag["translation"]["rmse"], "ate_deg": ate_flag["rotation_deg"]["rmse"],
                         "sinkhorn_launches": launches_flag},
            "camera": {"ms_per_scan": ms_cam, "frontend_ms_per_frame": fe_ms, "n_scans": N_SCANS,
                       "ate_m": ate_cam["translation"]["rmse"], "ate_deg": ate_cam["rotation_deg"]["rmse"],
                       "sinkhorn_launches": launches_cam},
            "render": [{"vantage": n, "covered": c, "ms": ms} for n, c, ms in renders],
            "per_hypothesis": per_hyp,
            "per_hypothesis_shared_extraction": shared_ext,
            **live,
            "options": options,
            "bag": bag,
            "canonical": canon,
            "f32_flagship": f32,
            "sweep": sweep_rec,
        }
    else:
        print(f"phases 3-14, 16 and 17 skipped (--phases {args.phases}): the kernels line holds phase "
              f"{alone[-1]}'s instances")

    if full or alone[-1] == 15:
        # 15. the sweep over a device mesh
        mesh_rec, launches_mesh = phase_mesh(device, sweep_poses)
        lap("phase 15")
        for key, n in launches_mesh.items():
            sinkhorn_launches[key] = sinkhorn_launches.get(key, 0) + n
        paths["mesh"] = mesh_rec

    if full:
        # 16. the tools on the card's host, on phase 11's bag and run
        paths["tools"] = phase_tools()
        lap("phase 16")

        # 17. the measurement layer: boot, ledger, syncs, step profile, census, scatter
        paths["runtime"] = phase_runtime(
            device, run, ledger_flag, paths["per_hypothesis"]["flagship_profile"]["eager"]["launch_calls_per_scan"])
        lap("phase 17")

    if full or alone[-1] == 18:
        # 18. the compiled step: no syncs, graph against eager, routes, timing
        paths["compiled_step"] = phase_compiled(device, *((run, out_flag) if full else ()))
        sinkhorn_launches[("float64", 1, 1024)] = (sinkhorn_launches.get(("float64", 1, 1024), 0)
                                                   + paths["compiled_step"]["sinkhorn_launches"])
        lap("phase 18")

    kernels = []
    for key, rec in sk.items():
        kernels.append(dict(
            name="sinkhorn_unbalanced", instance=f"{key[0]} {tuple(rec['shape'])}", paths=MAIN_SINKHORN[key],
            route="cuda", source="gcslam_torch/csrc/sinkhorn.cu", replaces="gcslam_tpu/ops/sinkhorn_pallas.py:59",
            launches=sinkhorn_launches.get(key, 0), max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=None))
    for key, rec in rs.items():
        err = max(rec["max_abs_err"], err_render) if key == (240, 320) and full else rec["max_abs_err"]
        kernels.append(dict(
            name="render_splats_raster", instance=f"float32 {tuple(rec['shape'])}",
            paths="map render" if key == (240, 320) else "viewer", route="cuda",
            source="gcslam_torch/csrc/raster.cu", replaces="gcslam_tpu/outputs/rendering_pallas.py:128",
            launches=raster_launches.get(key, 0), max_abs_err=err, ms=rec["ms"], device_ms=rec["device_ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None))
    for name in EIGEN_COUNTERS:
        if not any(k[0] == name and n > 0 for k, n in EIGH_LAUNCHES.items()):
            fail(f"the main paths launched no {name} kernel")
    EIGH_SEEN.uninstall()
    phase_eigh_paths(eg)
    lap("phase 2 on the paths' eigh inputs")
    for key, rec in sorted(eg.items()):
        kernels.append(dict(
            name=key[0], instance=f"{key[1]} {key[2]}", paths=", ".join(EIGH_PATHS.get(key, [])), route="cuda",
            source="gcslam_torch/csrc/eigh.cu", replaces=EIGH_REPLACES[key[0]],
            launches=EIGH_LAUNCHES.get(key, 0), launches_per_flagship_scan=eigh_per_scan.get(key),
            max_abs_err=rec["max_abs_err"], rel_err=rec["rel_err"], bit_equal=rec["bit_equal"], ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"], library_device_ms=rec["library_device_ms"],
            chain_floor_ms=rec["chain_floor_ms"], empty_kernel_ms=rec["empty_kernel_ms"],
            unpadded_trace_found=rec["unpadded_trace_found"],
            **{k: rec[k] for k in ("eigh_library_ms", "eigh3_device_ms", "epilogue_kernels", "epilogue_device_ms",
                                   "projection_kernels_of_20")
               if k in rec}))
    # the main paths' Lie-group launches: this process's since phase 2 (lap()), the f32 child's, the mesh ranks';
    # frozen here, since phase 2's checks below launch the kernel too
    LIE_LAUNCHES.update(lie_counts())
    LIE_SEEN.uninstall()
    lie_launches = dict(LIE_LAUNCHES)
    phase_lie_paths(lie, lie_launches)
    lap("phase 2 on the paths' Lie-group operands")
    for key, rec in sorted(lie.items()):
        kernels.append(dict(
            name="lie", instance=f"{key[0]} {key[1]} {key[2]}",
            paths="the step" if key in lie_per_scan else rec["inputs"].removesuffix("'s own"), route="cuda",
            source="gcslam_torch/csrc/se3.cu", replaces=LIE_REPLACES, launches=lie_launches.get(key, 0),
            launches_per_flagship_scan=lie_per_scan.get(key), library_ms=None, **rec))
    # an eigh instance and a float32 cast of a flagship scan's Lie-group instance are phase 2's own checks,
    # kept where a main path launched them; every other row's instance must have been launched
    cast = {k["instance"] for k in kernels if k["name"] == "lie" and k["launches"] == 0 and "cast to" in k["inputs"]}
    print(f"lie: {len(cast)} float32 casts of the flagship scan's instances no main path launched, not listed")
    dropped = lambda k: k["name"] in EIGEN_COUNTERS or k["name"] == "lie" and k["instance"] in cast  # noqa: E731
    kernels = [k for k in kernels if k["launches"] > 0 or not dropped(k)]
    missing = [f"{k['name']} {k['instance']}" for k in kernels if k["launches"] < 1]
    if full and missing:
        fail(f"kernel instances the main paths never launched: {missing}")
    if not full:
        kernels = [k for k in kernels if k["launches"] > 0]
    paths["eigh_sym_random_spectrum"] = eigh_random
    margins = [m for t in DEVICE_TRACE_LOG if t["margins_ms"] for m in t["margins_ms"]]
    paths["device_traces"] = dict(count=len(DEVICE_TRACE_LOG),
                                  retried=[t for t in DEVICE_TRACE_LOG if t["attempts"] > 1],
                                  margins_ms=[min(margins), max(margins)] if margins else None)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "device_traces.json"), "w") as f:
        json.dump(DEVICE_TRACE_LOG, f, indent=1)
    print(json.dumps({"paths": {**paths, "seconds": seconds}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
