"""Host seconds of the capture of the cell's compiled step (the program's
CompiledStep.capture_s, summed over the cached graphs; instantiation
included)."""


def read(ctx, name):
    return ctx["run"].capture_s
