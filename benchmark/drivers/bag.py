"""Closed-loop passes from the bag file on disk to poses on the host, back
to back: the program's load_bag (in the span `load_bag`), then a replay as
drivers/replay.py runs it (runner, chunk, loop detector) -- what
`eval.run --bag <bag> --config <config> --loop --chunk <chunk>` does less
writing its artifacts.

Traffic parameters: those of drivers/replay.py with source "bag". The
end-to-end metric, bag_ms_per_scan, is the window's wall time over the
scans processed in it. The compared pass is one of the window's first
three, drawn from the seed: its decoded batches against the reference's
decode of the same file, and its segments as drivers/replay.py compares
them. The bag's synthesis (a seed's first run writes it, later runs read
it) is not set-up."""

from __future__ import annotations

from benchmark.drivers.common import Program, seeded, window_of_passes
from benchmark.drivers.replay import compared, replay
from benchmark.gen import scans as gen
from benchmark.reference import check
from benchmark.reference.plain.frontend import rosbag as rrosbag


def drive(run) -> None:
    cell, cfg, tr = run.cell, run.cell.config, run.cell.traffic
    sampled = int(seeded(run.seed, 1).integers(0, 3))
    prog = Program(cfg, run.device)
    run.program = prog
    path = gen.timed_bag_file(run, cfg, tr, cell.config_dir)
    bag_cfg = gen.bag_config(prog.rosbag, cfg, cell.config_dir)
    run.program_init = check.state_tree(prog.init_state(prog.cfg, device=run.device))
    states = {}

    def one_pass(record: bool):
        with run.spans.span("load_bag"):
            batches = prog.rosbag.load_bag(path, config=bag_cfg, device=run.device)[0]
        poses, tapes, loop = replay(run, prog, batches, record, states)
        return len(batches), poses, ([check.state_tree(b) for b in batches] if record else None, poses, tapes, loop)

    one_pass(False)  # warm-up: the libraries, the decoder and the graph's capture
    record = window_of_passes(run, one_pass, sampled)
    run.e2e["bag_ms_per_scan"] = 1e3 * run.window_s / max(run.attempted, 1)
    if record is None:
        raise RuntimeError("the compared pass raised")
    decoded, poses, tapes, loop = record
    batches = [prog.batch_from_numpy(d, device=run.device) for d in decoded]  # the same values, on the device
    segs, mismatch = compared(run, prog, batches, poses, tapes, loop, states)
    run.record = check.PassRecord(
        ref_batches=lambda: rrosbag.load_bag(path, config=gen.bag_config(rrosbag, cfg, cell.config_dir),
                                             device=run.device)[0],
        poses=poses, tapes=tapes, states=states, segments=segs, loop=loop,
        decoded=decoded, resume_mismatch=mismatch)
