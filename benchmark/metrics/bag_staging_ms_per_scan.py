"""Host ms a scan in the runners' staging of a bag: the program's host
spans run_bag.start (validate, init_state, the state to the device),
run_bag.stack and run_bag.to_device, summed over the run's untraced
calls, over the scans they stepped (the span step.outputs). None where the
program has no spans, or no compiled step is cached."""

import importlib

STAGING = ("run_bag.start", "run_bag.stack", "run_bag.to_device")


def read(ctx, name):
    prog = ctx["run"].program
    spans = getattr(importlib.import_module("gcslam_torch.utils.profiling"), "SPANS", None)
    if prog is None or spans is None or not prog.runner.compiled_steps() or not spans.calls.get("step.outputs"):
        return None
    return 1e3 * sum(spans.seconds.get(k, 0.0) for k in STAGING) / spans.calls["step.outputs"]
