"""The host's kernel-launch calls (cudaLaunchKernel*, cuLaunchKernel*) in
the traced stretch, a scan."""


def read(ctx, name):
    s = ctx["stretch"]
    return None if s is None or not s.n_scans else s.launch_calls / s.n_scans
