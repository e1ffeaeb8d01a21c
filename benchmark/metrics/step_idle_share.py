"""The share of the runner calls' device span spent between steps, in %:
the program's stage clock (runner.stage_reading()), over every untraced
replay of the run (a call under torch.profiler leaves the clock as it
was). The time between one step's end and the next step's start in one
call holds the scan's staging copies and the replay's launch, and the
device's idle time there; device_idle_share is its profiled counterpart.
None where the program has no clock, or no step has run on one."""


def read(ctx, name):
    prog = ctx["run"].program
    reading = getattr(prog.runner, "stage_reading", lambda: None)() if prog is not None else None
    return None if reading is None else 100.0 * reading.between_share
