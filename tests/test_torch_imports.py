"""The port must run where JAX is absent: its modules import neither jax
nor the JAX package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the bag-preparation, bag-forensics, trajectory and device tools
FORENSIC_TOOLS = [
    "kimera_calibration_to_gc", "compute_time_alignment", "apply_imu_extrinsic", "validate_conventions",
    "bag_info", "first_n_messages_summary", "inspect_bag_deep", "inspect_odom_covariance", "inspect_odom_source",
    "inspect_camera_frames", "dump_raw_imu_odom", "plot_wz_odom", "compare_accel_odom", "compare_imu_sources",
    "check_extrinsics", "check_lidar_mount_angle", "check_turn_invariant", "diagnose_frames",
    "diagnose_trajectory_axes", "evaluate_trajectory_2d", "diagnose_trajectory_alignment", "trajectory_swaps",
    "replay_map_events", "dead_reckon", "estimate_extrinsics", "diagnose_gyro_composition",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import gcslam_torch.models.runner, gcslam_torch.frontend.synthetic, gcslam_torch.eval.ate_rpe\n"
        "import gcslam_torch.ops.sinkhorn\n"
        "import gcslam_torch.frontend.camera, gcslam_torch.outputs.rendering, gcslam_torch.outputs.raster\n"
        "import gcslam_torch.outputs.tum, gcslam_torch.outputs.splat_export, gcslam_torch.outputs.diagnostics\n"
        "import gcslam_torch.tools.view_splats, gcslam_torch.ops.cuda_build\n"
        "import gcslam_torch.frontend.loop, gcslam_torch.utils.checkpoint\n"
        "import gcslam_torch.frontend.cdr, gcslam_torch.frontend.mcap, gcslam_torch.frontend.native\n"
        "import gcslam_torch.frontend.images, gcslam_torch.frontend.time_alignment, gcslam_torch.frontend.rosbag\n"
        "import gcslam_torch.frontend.bag_synth, gcslam_torch.eval.gt_tools, gcslam_torch.eval.audit\n"
        "import gcslam_torch.eval.run, gcslam_torch.models.manifest, gcslam_torch.outputs.dashboard\n"
        "import gcslam_torch.outputs.live_view, gcslam_torch.outputs.rerun_export, gcslam_torch.ops.bev\n"
        "import gcslam_torch.tools.make_synth_bag, gcslam_torch.tools.rehearse, gcslam_torch.tools.precision_compare\n"
        "import gcslam_torch.parallel.sweep, gcslam_torch.tools.attribute_step, gcslam_torch.tools.ablate_gn_shared\n"
        "import gcslam_torch.utils.cuda_profile, gcslam_torch.parallel.mesh, gcslam_torch.parallel.dryrun\n"
        "import gcslam_torch.ops.collectives, gcslam_torch.utils.tree, gcslam_torch.outputs.svg_plot\n"
        "import gcslam_torch.utils.profiling, gcslam_torch.tools.profile_step, gcslam_torch.tools.kernel_census\n"
        "import gcslam_torch.tools.warm_cache, gcslam_torch.tools.cold_start, gcslam_torch.tools.microbench_scatter\n"
        "from gcslam_torch.models.manifest import compute_cert\n"
        "from gcslam_torch.ops.se3 import vee, so3_right_jacobian, so3_right_jacobian_inv, se3_plus, se3_minus\n"
        "from gcslam_torch.ops.se3 import se3_adjoint, se3_cov_compose, se3_identity, apply_pose_to_points\n"
        "from gcslam_torch.ops.linalg import inv_mass, clamp\n"
        "from gcslam_torch.models.belief import from_moments\n"
        "from gcslam_torch.frontend.rosbag import cdrless_rotvec\n"
        "import importlib; sys.modules['matplotlib'] = None  # the card's host has none\n"
        f"for t in {FORENSIC_TOOLS!r}: importlib.import_module('gcslam_torch.tools.' + t)\n"
        "from gcslam_torch.parallel.sweep import shard_states, shard_batches, gather_states, gather_atlas\n"
        "from gcslam_torch.utils.checkpoint import save_state_sharded, load_state_sharded\n"
        "sys.path.insert(0, 'tests'); import torch_mesh_ranks  # the mesh tests' rank worker\n"
        "from gcslam_torch.models.runner import run_scan, run_stream, run_chunked, DeadEndMonitor\n"
        "from gcslam_torch.frontend.camera import extract_camera_features_native\n"
        "from gcslam_torch.models.config import config_from_file\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'gcslam_tpu')) and sys.modules[m]]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_sources_do_not_reference_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gcslam_tpu)\b|gcslam_tpu", re.M)
    offenders = [str(p) for p in (ROOT / "gcslam_torch").rglob("*") if p.suffix in (".py", ".cu", ".cpp")
                 and pattern.search(p.read_text())]
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax_and_needs_the_card(tmp_path):
    """chip_smoke.py imports nothing of JAX or the JAX package (the TPU
    kernel paths it reports are data), and without a card — or without the
    rest of the repository — it exits non-zero and prints no result line."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|gcslam_tpu)\b", src, re.M)
    block_jax = "import sys; sys.modules['jax'] = None; sys.argv = ['chip_smoke.py']; "
    for cwd, setup in ((ROOT, "import torch; torch.cuda.is_available = lambda: False; "), (tmp_path, "")):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(src)
        code = block_jax + setup + "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')"
        out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=300,
                             env={k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"})
        assert out.returncode != 0, (cwd, out.stdout, out.stderr)
        assert '"ok": true' not in out.stdout
