"""The share of the traced stretch's wall time in which the device ran
nothing: 1 - union of device activity / stretch, in %."""


def read(ctx, name):
    s = ctx["stretch"]
    return None if s is None or s.window_s <= 0 or s.busy_s <= 0 else 100.0 * (1.0 - s.busy_s / s.window_s)
