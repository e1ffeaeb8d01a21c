"""Device kernel records (copies and sets left out) in the traced stretch,
a scan."""


def read(ctx, name):
    s = ctx["stretch"]
    return None if s is None or not s.n_scans or not s.kernels else s.kernels / s.n_scans
