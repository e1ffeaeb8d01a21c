"""Closed-loop replays of whole bags, back to back, each from a fresh
init_state and ending with its poses on the host.

Traffic parameters:
  source       "synthetic": `bags` bags made from the seed by the frozen
               generator, on the host, replayed in turn; "bag": the
               configuration's bag file (made from the seed, cached; the
               seconds its synthesis takes are not set-up), decoded once
               in set-up by the program's load_bag;
  runner       "run_bag": each replay is one run_bag over the whole bag;
               "run_chunked": run_chunked(chunk) with a fresh loop
               detector;
  check_scans  L, the length of a compared segment (common.segments).

The end-to-end metric, replay_ms_per_scan, is the window's wall time over
the scans replayed in it; the window ends with the replay that crosses
`seconds`. The compared pass is one of the window's first three, drawn
from the seed. Once the window has closed it is replayed again through
run_bag in pieces that end where the compared segments start, with the
loop factors run_chunked merged (common.resumed): the pieces' states are
where the reference starts, and `resume_mismatch` counts what of the
second replay differs from the timed one."""

from __future__ import annotations

from benchmark.drivers.common import (Program, TimedDetector, chunked_factors, resumed, seeded, segments,
                                      tapes_of, window_of_passes)
from benchmark.gen import scans as gen
from benchmark.reference import check


def replay(run, prog: Program, batches: list, record: bool, states: dict):
    """One replay: (poses (n, 6), tapes, loop calls) on the host; `states`
    gets the final state when `record`."""
    tr = run.cell.traffic
    det = None
    if tr["runner"] == "run_bag":
        s, o = prog.runner.run_bag(batches, prog.cfg, device=run.device)
    else:
        det = TimedDetector(prog.detector(), run.spans, record)
        s, o = prog.runner.run_chunked(batches, prog.cfg, chunk=tr["chunk"], loop_detector=det, device=run.device)
    poses = o.pose.cpu().numpy()
    if not record:
        return poses, None, None
    states[len(batches)] = check.state_tree(s)
    loop = None if det is None else check.LoopCalls(det.calls, inject_positive_only=True)
    return poses, tapes_of(o), loop


def compared(run, prog: Program, batches: list, poses, tapes, loop, states: dict) -> tuple:
    """The compared pass's segments, with `states` filled by its second
    replay; returns (segments, resume_mismatch)."""
    tr = run.cell.traffic
    n = len(batches)
    segs = segments(n, tr["check_scans"])
    factors = chunked_factors(loop.calls, n, tr["chunk"]) if loop is not None else {}
    cuts = sorted({k for k, _ in segs[1:]} | {n})
    return segs, resumed(prog, batches, cuts, run.device, poses, tapes, states, factors)


def drive(run) -> None:
    cell, cfg, tr = run.cell, run.cell.config, run.cell.traffic
    n = cfg["n_scans"]
    sampled = int(seeded(run.seed, 1).integers(0, 3))
    prog = Program(cfg, run.device)
    run.program = prog
    if tr["source"] == "synthetic":
        ref_bags = [gen.synthetic_scans(cfg, tr, run.seed * tr["bags"] + j, n) for j in range(tr["bags"])]
        bags = [prog.batches(b) for b in ref_bags]
        decoded = None
    else:
        from benchmark.reference.plain.frontend import rosbag as rrosbag

        path = gen.timed_bag_file(run, cfg, tr, cell.config_dir)
        bags = [prog.rosbag.load_bag(path, config=gen.bag_config(prog.rosbag, cfg, cell.config_dir),
                                     device=run.device)[0]]
        ref_bags = [lambda: rrosbag.load_bag(path, config=gen.bag_config(rrosbag, cfg, cell.config_dir),
                                             device=run.device)[0]]
        decoded = [check.state_tree(b) for b in bags[0]]
    run.program_init = check.state_tree(prog.init_state(prog.cfg, device=run.device))

    states = {}
    replay(run, prog, bags[0], False, {})  # warm-up: the graph's capture
    count = [0]

    def one_pass(record: bool):
        b = count[0] % len(bags)
        count[0] += 1
        poses, tapes, loop = replay(run, prog, bags[b], record, states)
        return n, poses, (poses, tapes, loop, b)

    record = window_of_passes(run, one_pass, sampled)
    run.e2e["replay_ms_per_scan"] = 1e3 * run.window_s / max(run.attempted, 1)
    if record is None:
        raise RuntimeError("the compared replay raised")
    poses, tapes, loop, b = record
    segs, mismatch = compared(run, prog, bags[b], poses, tapes, loop, states)
    run.record = check.PassRecord(ref_batches=ref_bags[b], poses=poses, tapes=tapes, states=states,
                                  segments=segs, loop=loop, decoded=decoded, resume_mismatch=mismatch)
