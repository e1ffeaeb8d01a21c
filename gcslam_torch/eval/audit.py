"""Run auditor (counterpart of the JAX package's eval/audit.py): post-run
invariant checks over the emitted artifacts — the wiring_auditor +
audit-in-the-loop analog (reference frontend/audit/wiring_auditor.py:37-265
and run_and_evaluate_gc.sh:488-495, which re-runs the invariant pytest
against the live run's outputs).

Checks (each -> pass/fail + detail):
  - manifest present, chart GC-RIGHT-01, budgets match compiled constants
  - trajectory: finite, monotone stamps, no teleports (bound = 8x the p95
    per-scan step, floored at 0.5 m — data-derived, platform-independent)
  - diagnostics: all tape fields finite; alpha/beta in declared ranges;
    triggers only from the registered taxonomy
  - splat export: finite, PSD covariances, masses >= 0
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from gcslam_torch import constants as C
from gcslam_torch.ops.certs import TRIGGERS


def audit_run(out_dir: str) -> Dict:
    results = {}

    def check(name, ok, detail=""):
        results[name] = {"pass": bool(ok), "detail": detail}

    # manifest
    try:
        with open(f"{out_dir}/runtime_manifest.json") as f:
            man = json.load(f)
        check("manifest_present", True)
        check("manifest_chart", man.get("chart_id") == C.CHART_ID, man.get("chart_id"))
        check("manifest_budget_k_hyp", man.get("config.k_hyp") == C.K_HYP)
        check(
            "manifest_budget_points",
            man.get("config.n_points_cap") == C.N_POINTS_CAP,
        )
    except FileNotFoundError:
        check("manifest_present", False)

    # trajectory
    try:
        traj = np.loadtxt(f"{out_dir}/trajectory.tum").reshape(-1, 8)
        check("traj_finite", np.all(np.isfinite(traj)))
        check("traj_monotone_stamps", np.all(np.diff(traj[:, 0]) > 0))
        step = np.linalg.norm(np.diff(traj[:, 1:4], axis=0), axis=1)
        # Teleport bound derived from the DATA, not a fixed 5 m: the rig's
        # own speed distribution sets the plausible per-scan displacement.
        # Robust scale = p95 step; bound = max(8x p95, 0.5 m) covers speed
        # bursts while catching solver blow-ups on fast AND slow platforms
        # (a fixed 5 m is wrong for highway rigs and toothless indoors).
        if len(step):
            bound = max(8.0 * float(np.percentile(step, 95)), 0.5)
            check("traj_no_teleports", np.all(step < bound),
                  f"max step {step.max():.3f} m vs bound {bound:.2f} m (8x p95)")
    except OSError:
        check("traj_finite", False, "trajectory.tum missing")

    # diagnostics
    try:
        diag = np.load(f"{out_dir}/diagnostics.npz")
        bad = [k for k in diag.files if diag[k].dtype.kind == "f" and not np.all(np.isfinite(diag[k]))]
        check("diag_finite", not bad, f"non-finite: {bad}")
        if "fusion_alpha" in diag:
            a = diag["fusion_alpha"]
            # dtype-aware bound tolerance: f32-belief runs round the clamped
            # controls by ~eps_f32, not ~eps_f64
            tol = 1e-9 if a.dtype == np.float64 else 1e-5
            check("alpha_in_range", np.all((a >= C.ALPHA_MIN - tol) & (a <= C.ALPHA_MAX + tol)))
        if "power_beta" in diag:
            b = diag["power_beta"]
            tol = 1e-9 if b.dtype == np.float64 else 1e-5
            # Taped beta is the hypothesis-WEIGHTED MEAN. Each hypothesis
            # beta is either >= POWER_BETA_MIN * its trust scale, or exactly
            # 0 (certified NonFiniteEvidence rejection, e.g. the empty-map
            # first scan). A scan mixing rejected and live hypotheses can
            # therefore legitimately land anywhere in [0, beta_lo) — but
            # ONLY when that scan's trigger mask carries NonFiniteEvidence.
            beta_lo = C.POWER_BETA_MIN * min(C.HYP_BETA_SCALE)
            ok_b = (b >= beta_lo - tol) | (b <= 1e-12)
            if "cert_triggers" in diag:
                nfe = (
                    diag["cert_triggers"].astype(np.int64)
                    & TRIGGERS["NonFiniteEvidence"]
                ) != 0
                ok_b = ok_b | (nfe & (b >= -tol) & (b < beta_lo))
            check("beta_in_range", np.all(ok_b & (b <= 1.0 + tol)))
        if "ee_pose_shift_pred" in diag:
            # ExpectedEffect audit (reference certificates.py:488): the
            # realized recompose magnitude must track the predicted fused
            # increment — BCH3 is a THIRD-order correction, so realized is
            # within a small factor of predicted whenever the shift is
            # non-trivial.
            pred = diag["ee_pose_shift_pred"]
            real = diag["ee_pose_shift_real"]
            sig = pred > 1e-6
            ratio = real[sig] / pred[sig] if np.any(sig) else np.ones(1)
            check(
                "expected_effect_pose_shift",
                np.all((ratio > 0.5) & (ratio < 2.0)),
                f"realized/predicted in [{ratio.min():.3f}, {ratio.max():.3f}]"
                if np.any(sig) else "no significant shifts",
            )
        if "ee_info_gain_pred" in diag:
            # realized info gain can't exceed the claimed alpha*tr(L_ev)
            # by more than the PSD-projection slack
            gp = diag["ee_info_gain_pred"]
            gr = diag["ee_info_gain_real"]
            check(
                "expected_effect_info_gain",
                np.all(gr <= gp * 1.05 + 1e-6),
                f"max realized-predicted {np.max(gr - gp):.3e}",
            )
        if "cert_triggers" in diag:
            all_bits = 0
            for bit in TRIGGERS.values():
                all_bits |= bit
            masks = diag["cert_triggers"].astype(np.int64)
            check("triggers_registered", np.all((masks & ~all_bits) == 0))
    except OSError:
        check("diag_finite", False, "diagnostics.npz missing")

    # splats
    try:
        sp = np.load(f"{out_dir}/splat_export.npz")
        check("splats_finite", all(np.all(np.isfinite(sp[k])) for k in ("mu_world", "Sigma_world")))
        # a non-finite covariance must FAIL the check above, not crash the
        # auditor (LAPACK refuses to converge on NaN rows) — scrub first
        Sig = np.nan_to_num(sp["Sigma_world"], nan=0.0, posinf=0.0, neginf=0.0)
        eig = np.linalg.eigvalsh(Sig) if Sig.size else np.zeros((1, 3))
        check("splats_psd", np.all(eig > -1e-9), f"min eig {eig.min():.2e}" if eig.size else "")
        check("splats_mass_nonneg", np.all(sp["masses"] >= 0))
    except OSError:
        check("splats_finite", True, "no splat export (no-map run)")

    results["all_pass"] = all(v["pass"] for k, v in results.items() if isinstance(v, dict))
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    args = p.parse_args(argv)
    res = audit_run(args.out_dir)
    print(json.dumps(res, indent=2))
    raise SystemExit(0 if res["all_pass"] else 1)


if __name__ == "__main__":
    main()
