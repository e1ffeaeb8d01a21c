"""The metric arithmetic on made-up traces and samples."""

import statistics
import time

import pytest

from benchmark import roofline, trace
from benchmark.drivers.live import Paced, p95
from benchmark.roofline import eigh_sym, sinkhorn


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 45)]
    assert trace.union_length(iv, 0, 50) == 15 + 11 + 5
    assert trace.union_length(iv, 8, 42) == 7 + 11 + 2
    assert trace.idle_gaps(iv, 0, 50) == [(15, 20), (31, 40), (45, 50)]
    assert trace.idle_gaps([], 3, 9) == [(3, 9)]
    assert trace.union_length([(0, 100)] * 3, 0, 100) == 100


def test_gap_labels_take_the_innermost_host_event():
    host = [(0, 100, "bench.replay"), (10, 30, "cudaGraphLaunch"), (50, 60, "bench.loop")]
    assert trace.label_at(20, host) == "cudaGraphLaunch"
    assert trace.label_at(55, host) == "bench.loop"
    assert trace.label_at(99, host) == "bench.replay"
    assert trace.label_at(150, host) == "host: untraced"
    assert trace.short_name("void sinkhorn_kernel<double, 8>(double const*, int)") == "sinkhorn_kernel<double, 8>"


def test_p95_over_every_sample():
    lat = list(range(1, 201))
    assert p95(lat) == statistics.quantiles(lat, n=20, method="inclusive")[18]
    assert 190 <= p95(lat) <= 191
    assert p95([5.0] * 199 + [1e9]) == 5.0


def test_pacing_releases_each_scan_at_its_due_time():
    p = Paced(list(range(6)), rate_hz=100.0)
    p.t0 = time.perf_counter() + 0.02
    got = [p[i] for i in range(len(p))]
    t_end = time.perf_counter()
    assert got == list(range(6))
    assert [p.due(i) - p.t0 for i in range(3)] == pytest.approx([0.0, 0.01, 0.02], abs=1e-9)
    lat = p.latencies(t_end)
    assert len(lat) == 6 and all(x >= 0 for x in lat)
    assert lat[-1] == pytest.approx(t_end - p.due(5))
    assert p.requested[0] < p.due(0)  # requested early, released when due


def test_roofline_counts():
    cfg = {"pipeline": {"k_sinkhorn": 50}}
    B, N, K = 1, 1024, 8
    b = 8 * (2 * N * K + N + K)
    ops = 3 * N * K + 50 * (4 * N * K + N + K)
    assert sinkhorn.seconds("float64", (B, N, K), cfg) == max(b / 3.35e12, ops / 34e12)
    assert sinkhorn.seconds("float32", (2, N, K), cfg) == max(2 * b / 2 / 3.35e12, 2 * ops / 67e12)
    # 22 x 22: 15 sweeps x 21 rounds x 11 rotations x (20 + 18 * 22), plus 3 n^2
    assert eigh_sym.flops(22) == 15 * 21 * 11 * 416 + 3 * 484
    assert eigh_sym.flops(5) == 15 * 5 * 3 * 110 + 75
    assert eigh_sym.seconds("float64", (4, 22, 22), cfg) == max(8 * 4 * (2 * 484 + 22) / 3.35e12,
                                                                4 * eigh_sym.flops(22) / 34e12)
    assert roofline.bound_seconds(3.35e12, 0, "float64") == 1.0
