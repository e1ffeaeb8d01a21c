"""The union of the device's activity (kernels, copies, sets) in the traced
stretch, a scan, in ms."""


def read(ctx, name):
    s = ctx["stretch"]
    return None if s is None or not s.n_scans or s.busy_s <= 0 else 1e3 * s.busy_s / s.n_scans
