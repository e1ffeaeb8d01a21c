"""The gated rehearsal of the canonical path, with frontend-stage
attribution (counterpart of the JAX package's tools/rehearse.py).

The reference's single test path is the gated bag replay
(tools/run_and_evaluate_gc.sh:333-645). No real bag ships here, so the
stand-in is the real-schema synthesized Kimera bag (frontend/bag_synth.py):
VLP-16 CDR scans, 200 Hz IMU, odometry, JPEG + depth camera frames,
per-topic inverse-skewed clocks. This tool

  1. synthesizes the bag with tools/make_synth_bag, once per set of
     synthesis arguments: they are stored beside the bag (`<bag>.args.json`)
     and a bag made with other arguments is made anew;
  2. runs the whole production frontend + pipeline on it
     (`python -m gcslam_torch.eval.run --bag`) and gates the `full`
     variant's ATE and audit (exit code 1 on a failure);
  3. attributes the bag-vs-control accuracy difference by changing one
     frontend stage at a time: the direct-ScanBatch control, camera off,
     raw (k = 1) anchor, time-alignment profile off, and the Python decode
     (GCSLAM_NO_NATIVE=1).

Usage:
  python -m gcslam_torch.tools.rehearse [--quick] [--cpu] [--json PATH]
         [--variants full,control,...] [--out-base DIR/PREFIX] [--bag PATH]

Every default path lies under results/, which git ignores.

Gate (the JAX package's production thresholds):
  ATE trans RMSE <= 0.38 m, ATE rot RMSE <= 4.0 deg, audit all pass.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GATE_TRANS_M = 0.38
GATE_ROT_DEG = 4.0

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "gc_kimera.yaml")
RESULTS = os.path.join("results", "rehearsal")

# name -> (uses the bag, extra eval.run arguments); the control's synthetic
# run takes --scans from the rehearsal
VARIANTS = {
    "full": (True, []),
    "control": (False, ["--trajectory", "circuit", "--odom-model", "integrated", "--drift", "0.02", "--camera",
                        "--loop"]),
    "no_camera": (True, ["--no-camera"]),
    "anchor_raw": (True, ["--frontend-set", "anchor_smoothing_k=1"]),
    "no_align": (True, ["--frontend-set", "alignment=none"]),
    "python_decode": (True, []),  # GCSLAM_NO_NATIVE=1
}


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])), **extra)


def ensure_bag(bag: str, gt: str, scans: int) -> bool:
    """Make the bag unless one made with these synthesis arguments exists;
    returns whether it was made."""
    synth = ["--config", CONFIG, "--scans", str(scans), "--trajectory", "circuit", "--odom-model", "integrated"]
    sidecar = bag + ".args.json"
    if os.path.exists(bag) and os.path.exists(gt) and os.path.exists(sidecar):
        with open(sidecar) as f:
            if json.load(f) == {"make_synth_bag": synth, "gt": gt}:
                return False
    for path in (bag, gt, sidecar):
        if os.path.exists(path):
            os.remove(path)
    os.makedirs(os.path.dirname(bag) or ".", exist_ok=True)
    print(f"[rehearse] synthesizing {bag} ...", flush=True)
    subprocess.run([sys.executable, "-m", "gcslam_torch.tools.make_synth_bag", "--out", bag, "--gt", gt] + synth,
                   check=True, env=_env())
    with open(sidecar, "w") as f:
        json.dump({"make_synth_bag": synth, "gt": gt}, f)
    return True


def run_variant(name: str, bag: str, gt: str, out_dir: str, scans: int, cpu: bool) -> dict:
    uses_bag, extra = VARIANTS[name]
    cmd = [sys.executable, "-m", "gcslam_torch.eval.run", "--out", out_dir, "--chunk", "10"]
    if uses_bag:
        cmd += ["--bag", bag, "--config", CONFIG, "--gt", gt, "--loop"]
    else:
        cmd += ["--scans", str(scans)]
    cmd += extra
    if cpu:
        cmd += ["--cpu"]
    env = _env(GCSLAM_NO_NATIVE="1") if name == "python_decode" else _env()
    print(f"[rehearse] {name}: {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env)
    if r.returncode != 0:
        return {"error": f"eval.run rc={r.returncode}"}
    with open(os.path.join(out_dir, "metrics.json")) as f:
        m = json.load(f)
    rpe = m["rpe"]["1m"]
    row = {
        "ate_trans_rmse_m": m["ate"]["translation"]["rmse"],
        "ate_rot_rmse_deg": m["ate"]["rotation_deg"]["rmse"],
        "rpe1m_trans_rmse_m": rpe["translation"]["rmse"] if rpe["translation"] else None,
        "rpe1m_rot_rmse_deg": rpe["rotation_deg"]["rmse"] if rpe["rotation_deg"] else None,
        "n_scans": m["n_scans"],
        "load_s": m["load_s"],
        "replay_s": m["wall_s"],
        "wall_s": time.perf_counter() - t0,
    }
    audit_path = os.path.join(out_dir, "audit.json")
    if os.path.exists(audit_path):
        with open(audit_path) as f:
            audit = json.load(f)
        row["audit_all_pass"] = all(v.get("pass", False) for v in audit.values() if isinstance(v, dict))
    return row


def gate(full: dict) -> list:
    """The failures of the full variant against the gate."""
    if "error" in full:
        return [full["error"]]
    failures = []
    if full.get("ate_trans_rmse_m", 1e9) > GATE_TRANS_M:
        failures.append(f"trans {full['ate_trans_rmse_m']} > {GATE_TRANS_M}")
    if full.get("ate_rot_rmse_deg", 1e9) > GATE_ROT_DEG:
        failures.append(f"rot {full['ate_rot_rmse_deg']} > {GATE_ROT_DEG}")
    if full.get("audit_all_pass") is False:
        failures.append("audit failed")
    return failures


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gcslam_torch.tools.rehearse")
    ap.add_argument("--json", default=os.path.join(RESULTS, "REHEARSAL.json"))
    ap.add_argument("--out-base", default=os.path.join(RESULTS, "run"))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--scans", type=int, default=160)
    ap.add_argument("--bag", default=os.path.join(RESULTS, "kimera_synth.db3"),
                    help="the synthesized bag (its ground truth goes beside it, <bag>_gt.tum)")
    ap.add_argument("--quick", action="store_true", help="gate only: run just the 'full' variant")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    names = ["full"] if args.quick else args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    bag = args.bag
    gt = os.path.splitext(bag)[0] + "_gt.tum"
    if any(VARIANTS[n][0] for n in names):
        t0 = time.perf_counter()
        made = ensure_bag(bag, gt, args.scans)
        print(f"[rehearse] bag {'made' if made else 'reused'} ({time.perf_counter() - t0:.1f} s)", flush=True)

    rows = {name: run_variant(name, bag, gt, f"{args.out_base}_{name}", args.scans, args.cpu) for name in names}
    failures = gate(rows["full"]) if "full" in rows else []
    report = {
        "gate": ("PASS" if not failures else "FAIL: " + "; ".join(failures)) if "full" in rows else "not run",
        "gate_thresholds": {"ate_trans_rmse_m": GATE_TRANS_M, "ate_rot_rmse_deg": GATE_ROT_DEG},
        "variants": rows,
        "bag": bag,
        "scans": args.scans,
    }
    out = json.dumps(report, indent=1)
    print(out)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(out + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
