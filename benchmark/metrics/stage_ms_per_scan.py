"""Device ms a scan in one stage of the compiled step, the stage being the
name's middle part (stage_ms_per_scan.<stage>.replay): the program's stage
clock (runner.stage_reading(), summed over the cached CompiledSteps), over
every untraced replay of the run: the warm pass, the window but its traced
pass, and the compared replay. None where the program has no clock, or no
step has run on one."""


def read(ctx, name):
    prog = ctx["run"].program
    reading = getattr(prog.runner, "stage_reading", lambda: None)() if prog is not None else None
    return None if reading is None else reading.ms_per_scan.get(name.split(".")[1])
