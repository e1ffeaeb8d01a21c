"""Host seconds a scan in the harness's `load_bag` span, over the window's
scans outside the traced stretch, in ms."""


def read(ctx, name):
    seconds = ctx["spans"].seconds.get("load_bag")
    scans = getattr(ctx["run"], "span_scans", 0)
    if not seconds or not scans:
        return None
    return 1e3 * seconds / scans
