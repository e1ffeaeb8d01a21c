"""Host ms a scan in the runner's step loop: the mean of the program's
host span step.launch (the scan staged into the graph's buffers and the
replay's launch) plus that of step.outputs (the outputs copied into their
rows), over the run's untraced calls; the launch waits there while the
device's queue is full. None where the program has no spans, or no
compiled step is cached."""

import importlib

NAMES = ("step.launch", "step.outputs")


def read(ctx, name):
    prog = ctx["run"].program
    spans = getattr(importlib.import_module("gcslam_torch.utils.profiling"), "SPANS", None)
    if prog is None or spans is None or not prog.runner.compiled_steps() or not all(map(spans.calls.get, NAMES)):
        return None
    return 1e3 * sum(spans.seconds[k] / spans.calls[k] for k in NAMES)
