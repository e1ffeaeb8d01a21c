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
traced: ("cuda",) alone keeps the host ops untraced (the runtime's launch
calls are still recorded). The counts are read from the trace's raw
events (raw_events).
"""

from __future__ import annotations

import collections
import time

# the keys of profile_record's result
FIELDS = ("launch_calls_per_scan", "device_kernels_per_scan", "device_busy_ms_per_scan", "profiled_span_ms_per_scan",
          "device_busy_share")
# the runtime calls that launch a kernel (cudaLaunchKernelExC, the
# Sinkhorn's cluster launch, among them)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
# device activity that is not a kernel
NOT_KERNELS = ("Memcpy", "Memset")


def profile(fn, activities=("cpu", "cuda")):
    """fn() under torch.profiler; returns (the profiler, the host-clock span
    in ms of the call and, when the card is traced, the synchronize after
    it). ("cpu",) alone traces the host ops of a run on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [{"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}[a] for a in activities]
    sync = torch.cuda.synchronize if "cuda" in activities else (lambda: None)
    sync()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        span_ms = 1e3 * (time.perf_counter() - t0)
    return prof, span_ms


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_CALLS)


def raw_events(prof) -> list:
    """The trace's events as the profiler recorded them. Reading them
    directly skips torch.profiler's events() / key_averages(), which build
    a Python tree of every event: over a minute for three production scans
    traced with the host ops."""
    return prof.profiler.kineto_results.events()


def device_activity(events) -> list:
    """The card's kernels, copies and sets (a record_function range's
    device-side annotation is none of them)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def kernel_counts(prof) -> collections.Counter:
    """Device kernels by name (copies and sets left out)."""
    return collections.Counter(e.name() for e in device_activity(raw_events(prof))
                               if not e.name().startswith(NOT_KERNELS))


def record(events, span_ms: float, n: int) -> dict:
    """profile_record's fields from the raw events of a trace of n scans."""
    from torch.autograd import DeviceType

    launch_calls = sum(1 for e in events if e.device_type() == DeviceType.CPU and is_launch(e.name()))
    dev = device_activity(events)
    kernels = sum(1 for e in dev if not e.name().startswith(NOT_KERNELS))
    busy_us = sum(e.duration_ns() for e in dev) / 1e3
    return dict(launch_calls_per_scan=launch_calls / n if launch_calls else None,
                device_kernels_per_scan=kernels / n if kernels else None,
                device_busy_ms_per_scan=busy_us / 1e3 / n if busy_us else None,
                profiled_span_ms_per_scan=span_ms / n,
                device_busy_share=(busy_us / 1e3) / span_ms if busy_us else None)


def profile_record(fn, n: int, activities=("cpu", "cuda")) -> dict:
    prof, span_ms = profile(fn, activities)
    return record(raw_events(prof), span_ms, n)


def implicit_syncs(fn) -> collections.Counter:
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the host syncs
    the card's operations make implicitly (a .item(), a nonzero, a
    factorization's info check), counted by the Python line that called
    the operation, as "path:line" (relative to the repository when inside
    it)."""
    import os
    import warnings

    import torch

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sites = collections.Counter()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    for w in caught:
        if "synchroniz" in str(w.message):
            path = os.path.relpath(w.filename, root) if w.filename.startswith(root) else w.filename
            sites[f"{path}:{w.lineno}"] += 1
    return sites
