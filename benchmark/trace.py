"""One traced stretch of a run, from torch.profiler, reduced to what the
per-layer metrics and the result's `breakdown` read: the union of the
device's activity (kernels, copies, sets) inside the stretch, its idle
gaps labelled by what the host was doing, kernel records and time by name,
and the host's kernel-launch calls. Everything is read from the trace's raw
events (torch.profiler's events() / key_averages() build a Python tree of
every event, minutes for a few hundred thousand kernels)."""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

ROOT_SPAN = "bench.traced"
# the runtime calls that hand the device work: kernel and graph launches,
# asynchronous copies and sets
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
NOT_KERNELS = ("Memcpy", "Memset")


def union_length(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_at(t: int, host: List[Tuple[int, int, str]]) -> str:
    """The innermost (shortest) host event that covers time t."""
    best = None
    for s, e, name in host:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host: untraced"


def short_name(name: str) -> str:
    """A kernel's name without its argument list (an anonymous namespace's
    parentheses stay)."""
    name = name[5:] if name.startswith("void ") else name
    depth, i = 0, 0  # template depth; parentheses inside <...> stay
    while i < len(name):
        c = name[i]
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            if name.startswith("(anonymous namespace)", i):
                i += len("(anonymous namespace)")
                continue
            return name[:i]
        i += 1
    return name


class Stretch:
    """Summary of a traced stretch of `n_scans` scans."""

    def __init__(self, events, n_scans: int):
        from torch.autograd import DeviceType

        self.n_scans = n_scans
        roots = [e for e in events if e.device_type() == DeviceType.CPU and e.name() == ROOT_SPAN]
        if not roots:
            raise RuntimeError(f"the trace holds no {ROOT_SPAN} span")
        root = roots[0]
        self.lo, self.hi = root.start_ns(), root.start_ns() + root.duration_ns()
        dev, host = [], []
        self.launch_calls = 0
        for e in events:
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and self.lo <= s < self.hi:
                    dev.append((s, s + d, name))
            elif e is not root and e.device_type() == DeviceType.CPU and self.lo <= s < self.hi:
                host.append((s, s + d, name))
                if name.startswith(LAUNCH_CALLS):
                    self.launch_calls += 1
        self.device = dev
        self.host = host
        spans = [(s, e) for s, e, _ in dev]
        self.window_s = (self.hi - self.lo) / 1e9
        self.busy_s = union_length(spans, self.lo, self.hi) / 1e9
        self.kernels = sum(1 for _, _, n in dev if not n.startswith(NOT_KERNELS))
        self._gaps = idle_gaps(spans, self.lo, self.hi)

    def kernel_time(self, pattern: str) -> Tuple[int, float]:
        """(records, seconds) of the device kernels whose name contains `pattern`."""
        hits = [e - s for s, e, n in self.device if pattern in n]
        return len(hits), sum(hits) / 1e9

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name = collections.Counter()
        for s, e, n in self.device:
            by_name[short_name(n)] += (e - s) / 1e9
        gaps = sorted(self._gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t] for n, t in by_name.most_common(top)],
                "idle_gaps": [[label_at((s + e) // 2, self.host), (e - s) / 1e9] for s, e in gaps]}


class Tracer:
    """start() ... stop(n_scans): torch.profiler over the stretch between,
    synchronized at both ends, inside the span the reduction keys on."""

    def __init__(self):
        self.prof = None
        self.stretch: Optional[Stretch] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.cuda = torch.cuda.is_available()
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.__enter__()
        self._root = record_function(ROOT_SPAN)
        self._root.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, n_scans: int) -> Stretch:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._root.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.stretch = Stretch(self.prof.profiler.kineto_results.events(), n_scans)
        self.prof = None
        return self.stretch
