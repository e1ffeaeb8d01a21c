"""Launches and device time of a stretch of the pipeline on the CUDA card,
from torch.profiler: the one definition of those metrics that the tools
and the on-card smoke script report.

profile_record(fn, n) runs fn() (n scans) under the profiler and returns,
per scan:
  - launch_calls_per_scan: the runtime's kernel-launch calls
    (cudaLaunchKernel, cuLaunchKernel) on the host;
  - device_kernels_per_scan: the kernels the device ran (copies and sets
    left out);
  - device_busy_ms_per_scan: the device's summed kernel, copy and set time;
  - profiled_span_ms_per_scan: the host-clock span of the profiled call
    (the profiler slows the host, so this is not the timed ms/scan);
  - device_busy_share: device busy over the span.
A count that the trace does not hold is None. `activities` names what is
traced: ("cuda",) alone keeps the host untraced, which costs ~15 s a scan
less than tracing every host op as well.
"""

from __future__ import annotations

import time

# the keys of profile_record's result
FIELDS = ("launch_calls_per_scan", "device_kernels_per_scan", "device_busy_ms_per_scan", "profiled_span_ms_per_scan",
          "device_busy_share")


def profile_record(fn, n: int, activities=("cpu", "cuda")) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [{"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}[a] for a in activities]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    launch_calls = sum(e.count for e in rows if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    dev = [e for e in rows if getattr(e, "device_type", None) == DeviceType.CUDA]
    kernels = sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset")))
    busy_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0) for e in dev)
    return dict(launch_calls_per_scan=launch_calls / n if launch_calls else None,
                device_kernels_per_scan=kernels / n if kernels else None,
                device_busy_ms_per_scan=busy_us / 1e3 / n if busy_us else None,
                profiled_span_ms_per_scan=span_ms / n,
                device_busy_share=(busy_us / 1e3) / span_ms if busy_us else None)
