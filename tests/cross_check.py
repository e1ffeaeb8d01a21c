"""Cross-package replays on the CPU, for the numbers PERF.md and ROADMAP.md
quote that no single package's CLI gives (not a test module):

  python tests/cross_check.py handover --bag b40.db3 --gt b40_gt.tum --scan 6
      the port replays scans 0..scan-1 of a Kimera-schema bag at
      configs/gc_kimera.yaml, hands its state to the JAX package, which
      replays the rest (and the converse with --jax-first); prints the
      ATE of the joined trajectory and the per-scan OT transport mass;
  python tests/cross_check.py evidence-imu --scans 20
      both packages replay generate(SyntheticConfig(n_scans, 8192 points))
      at PipelineConfig(imu_mode="evidence"); prints both ATEs and the
      largest per-scan pose difference;
  python tests/cross_check.py certificates --scans 10
      both packages replay the flagship (PipelineConfig()) on
      generate(SyntheticConfig(n_scans, 8192 points)) in the belief dtype
      GCSLAM_BELIEF_DTYPE gives; prints the PSD projection delta and
      cond_pose6 maxima of each tape.

Both run on the CPU (JAX_PLATFORMS=cpu; the JAX package unchanged) from
the repository root with PYTHONPATH set to it.
"""

import argparse
import dataclasses
import json

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

from gcslam_tpu.eval import ate_rpe as jate, gt_tools as jgt  # noqa: E402
from gcslam_tpu.frontend import rosbag as jrosbag  # noqa: E402
from gcslam_tpu.models import atlas as jatlas, runner as jrunner, scan_step as jstep  # noqa: E402
from gcslam_tpu.models.belief import Belief as JBelief  # noqa: E402
from gcslam_tpu.models.config import config_from_file as jconfig_from_file  # noqa: E402
from gcslam_tpu.ops import iw as jiw  # noqa: E402
from gcslam_tpu.outputs.tum import read_tum  # noqa: E402
from gcslam_tpu.utils.xla import jnp  # noqa: E402
from gcslam_torch.models import scan_step as tstep  # noqa: E402
from gcslam_torch.models.config import config_from_file as tconfig_from_file  # noqa: E402
from gcslam_torch.models.scan_io import batch_from_numpy  # noqa: E402

CONFIG = "configs/gc_kimera.yaml"


def jax_state(ns):
    """A JAX StepState from the port's numpy state."""
    s = jstep.StepState(beliefs=JBelief(*ns.beliefs), hyp_weights=ns.hyp_weights,
                        process_iw=jiw.ProcessNoiseIW(*ns.process_iw), meas_iw=jiw.MeasurementNoiseIW(*ns.meas_iw),
                        atlas=jatlas.AtlasState(*ns.atlas), scan_count=ns.scan_count)
    return jax.tree_util.tree_map(jnp.asarray, s)


def handover(args) -> dict:
    jb, _, _ = jrosbag.load_bag(args.bag, config=dataclasses.replace(jrosbag.bag_config_from_file(CONFIG),
                                                                     n_points=8192))
    tb = [batch_from_numpy({f: np.asarray(getattr(b, f)) for f in b._fields}, device="cpu") for b in jb]
    jc, tc = jconfig_from_file(CONFIG), tconfig_from_file(CONFIG)
    poses, mass = [], []

    def jax_steps(s, batches):
        for b in batches:
            s, o = jrunner._step_jit(s, b, jc)
            poses.append(np.asarray(o.pose))
            mass.append(float(o.tape.ot_transport_mass))
        return s

    def port_steps(s, batches):
        for b in batches:
            s, o = tstep.scan_step(s, b, tc)
            poses.append(o.pose.numpy())
            mass.append(float(o.tape.ot_transport_mass))
        return s

    k = args.scan
    if args.jax_first:
        s = jax_steps(jstep.init_state(jc), jb[:k])
        port_steps(tstep.state_from_numpy(jax.tree_util.tree_map(np.asarray, s), device="cpu"), tb[k:])
    else:
        s = port_steps(tstep.init_state(tc, device="cpu"), tb[:k])
        jax_steps(jax_state(tstep.state_to_numpy(s)), jb[k:])
    gt_stamps, gt = read_tum(args.gt)  # at the scan stamps, as eval.run scores
    gt, _ = jgt.interpolate_gt(gt_stamps, gt, np.asarray([float(b.t_scan) for b in jb]))
    ate = jate.compute_ate(np.stack(poses), gt, align="initial")
    return {"first": "jax" if args.jax_first else "port", "handover_scan": k,
            "ate_m": ate["translation"]["rmse"], "ate_deg": ate["rotation_deg"]["rmse"], "transport_mass": mass}


def evidence_imu(args) -> dict:
    from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
    from gcslam_tpu.models.config import PipelineConfig as JConfig
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig

    jrun = jgenerate(JSynth(n_scans=args.scans, n_points=8192))
    _, jout = jrunner.run_bag(jrun.batches, JConfig(imu_mode="evidence"))
    trun = generate(SyntheticConfig(n_scans=args.scans, n_points=8192), device="cpu")
    _, tout = runner.run_bag(trun.batches, PipelineConfig(imu_mode="evidence"), device="cpu")
    jp, tp = np.asarray(jout.pose), tout.pose.numpy()
    ja, ta = (jate.compute_ate(p, jrun.gt_poses, align="initial") for p in (jp, tp))
    return {"jax_ate_m": ja["translation"]["rmse"], "jax_ate_deg": ja["rotation_deg"]["rmse"],
            "port_ate_m": ta["translation"]["rmse"], "port_ate_deg": ta["rotation_deg"]["rmse"],
            "max_pose_diff_per_scan": np.abs(jp - tp).max(1).tolist()}


def certificates(args) -> dict:
    from gcslam_tpu.frontend.synthetic import SyntheticConfig as JSynth, generate as jgenerate
    from gcslam_tpu.models.config import PipelineConfig as JConfig
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.utils.dtypes import BELIEF_DTYPE

    _, jout = jrunner.run_bag(jgenerate(JSynth(n_scans=args.scans, n_points=8192)).batches, JConfig())
    trun = generate(SyntheticConfig(n_scans=args.scans, n_points=8192), device="cpu")
    _, tout = runner.run_bag(trun.batches, PipelineConfig(), device="cpu")
    out = {"belief_dtype": str(BELIEF_DTYPE)}
    for name, tape in (("jax", jax.tree_util.tree_map(np.asarray, jout.tape)),
                       ("port", jax.tree_util.tree_map(lambda x: x.numpy(), tout.tape))):
        out[name] = {"psd_projection_delta_max": float(np.max(tape.influence_psd_projection_delta)),
                     "cond_pose6_max": float(np.max(tape.cond_pose6))}
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("handover")
    h.add_argument("--bag", required=True)
    h.add_argument("--gt", required=True)
    h.add_argument("--scan", type=int, required=True, help="the first scan the second package replays")
    h.add_argument("--jax-first", action="store_true")
    e = sub.add_parser("evidence-imu")
    e.add_argument("--scans", type=int, default=20)
    c = sub.add_parser("certificates")
    c.add_argument("--scans", type=int, default=10)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    print(json.dumps({"handover": handover, "evidence-imu": evidence_imu, "certificates": certificates}[args.cmd](args)))


if __name__ == "__main__":
    main()
