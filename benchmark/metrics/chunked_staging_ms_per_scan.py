"""Host ms a scan in run_chunked's staging of a bag: the program's host
spans run_chunked.start (validate, init_state, the state to the device),
run_chunked.stack and run_chunked.to_device (the full windows' commit and
each remainder scan's), summed over the run's untraced calls, over the
scans they stepped (the span step.outputs). None where the program has no
such spans, or no compiled step is cached."""

import importlib

STAGING = ("run_chunked.start", "run_chunked.stack", "run_chunked.to_device")


def ms_per_scan(ctx, names) -> float:
    """The program's host spans `names`, summed, in ms over the scans
    stepped; None where it has none of them or no compiled step is cached."""
    prog = ctx["run"].program
    spans = getattr(importlib.import_module("gcslam_torch.utils.profiling"), "SPANS", None)
    if prog is None or spans is None or not prog.runner.compiled_steps() or not spans.calls.get("step.outputs"):
        return None
    if not any(spans.calls.get(k) for k in names):
        return None
    return 1e3 * sum(spans.seconds.get(k, 0.0) for k in names) / spans.calls["step.outputs"]


def read(ctx, name):
    return ms_per_scan(ctx, STAGING)
