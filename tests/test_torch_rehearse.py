"""The port's gated rehearsal (tools/rehearse): end to end with --cpu
--quick on a 4-scan bag (otherwise the rehearsal's arguments: 16384
returns, the 640 x 480 camera), the bag cache keyed on the synthesis
arguments, and
the six variants' commands against the JAX tool's (gcslam_tpu/tools/
rehearse.py:43-53,80-95)."""

import json
import os
import subprocess
import types

from gcslam_tpu.tools import rehearse as jrehearse
from gcslam_torch.tools import make_synth_bag, rehearse


def test_rehearse_quick_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one torch thread in each child, as in the parent
    bag = str(tmp_path / "bag" / "kimera.db3")
    report_path = tmp_path / "rehearsal.json"
    rc = rehearse.main(["--cpu", "--quick", "--scans", "4", "--bag", bag, "--json", str(report_path),
                        "--out-base", str(tmp_path / "run")])
    report = json.load(open(report_path))
    assert rc == 0 and report["gate"] == "PASS", report
    full = report["variants"]["full"]
    assert list(report["variants"]) == ["full"] and full["n_scans"] == 4 and full["audit_all_pass"]
    assert full["ate_trans_rmse_m"] <= rehearse.GATE_TRANS_M and full["ate_rot_rmse_deg"] <= rehearse.GATE_ROT_DEG
    assert (rehearse.GATE_TRANS_M, rehearse.GATE_ROT_DEG) == (jrehearse.GATE_TRANS_M, jrehearse.GATE_ROT_DEG)
    assert os.path.exists(tmp_path / "run_full" / "trajectory.tum")


def test_bag_cache_is_keyed_on_the_synthesis_arguments(tmp_path, monkeypatch):
    """The make_synth_bag command runs in this process (the quick test above
    runs it as the child process the tool starts)."""
    def in_process(cmd, check, env):
        assert cmd[1:3] == ["-m", "gcslam_torch.tools.make_synth_bag"] and check
        make_synth_bag.main(cmd[3:])

    monkeypatch.setattr(rehearse.subprocess, "run", in_process)
    bag, gt = str(tmp_path / "b.db3"), str(tmp_path / "b_gt.tum")
    assert rehearse.ensure_bag(bag, gt, scans=2)
    stamp, n_gt = os.stat(bag).st_mtime_ns, len(open(gt).readlines())
    assert not rehearse.ensure_bag(bag, gt, scans=2)  # same arguments: reused
    assert os.stat(bag).st_mtime_ns == stamp
    assert rehearse.ensure_bag(bag, gt, scans=3)  # another scan count: made anew
    assert len(open(gt).readlines()) > n_gt
    with open(bag + ".args.json") as f:
        synth = json.load(f)["make_synth_bag"]
    assert synth[synth.index("--scans") + 1] == "3"
    os.remove(bag + ".args.json")  # a bag of unknown arguments is made anew
    assert rehearse.ensure_bag(bag, gt, scans=3)


def test_variants_run_the_jax_tools_commands(tmp_path, monkeypatch):
    """Each variant's eval.run command and environment, captured without
    running them: the JAX tool's arguments with -m gcslam_torch.eval.run,
    and GCSLAM_NO_NATIVE=1 on python_decode only."""
    calls = []

    def fake_run(cmd, env=None, **kw):
        calls.append((cmd, env))
        return types.SimpleNamespace(returncode=1)

    monkeypatch.setattr(rehearse.subprocess, "run", fake_run)
    monkeypatch.setattr(rehearse, "ensure_bag", lambda *a: False)
    monkeypatch.delenv("GCSLAM_NO_NATIVE", raising=False)
    rc = rehearse.main(["--cpu", "--bag", str(tmp_path / "b.db3"), "--json", str(tmp_path / "r.json"),
                        "--out-base", str(tmp_path / "run")])
    report = json.load(open(tmp_path / "r.json"))
    assert rc == 1 and report["gate"].startswith("FAIL") and set(report["variants"]) == set(jrehearse.VARIANTS)
    assert [c[0][1:3] for c in calls] == [["-m", "gcslam_torch.eval.run"]] * 6
    for (cmd, env), name in zip(calls, rehearse.VARIANTS):
        uses_bag, extra = jrehearse.VARIANTS[name]
        assert cmd[-1] == "--cpu" and cmd[-1 - len(extra):-1] == extra  # the control's --scans 160 too
        assert ("--bag" in cmd) == uses_bag and ("--loop" in cmd)
        assert cmd[cmd.index("--chunk") + 1] == "10"
        assert (env.get("GCSLAM_NO_NATIVE") == "1") == (name == "python_decode")


def test_the_defaults_write_under_results():
    """Every default path lies under results/, which git ignores (the JAX
    tool writes REHEARSAL_r05.json at the root and its bag under /tmp)."""
    defaults = {a.dest: a.default for a in rehearse.parser()._actions}
    for key in ("json", "out_base", "bag"):
        assert defaults[key].startswith("results" + os.sep), (key, defaults[key])
    assert subprocess.run(["git", "check-ignore", "-q", "results/x"], cwd=rehearse.REPO).returncode == 0
