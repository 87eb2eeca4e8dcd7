"""The yardstick's arithmetic on hand-made inputs."""

import statistics
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import tracing  # noqa: E402
from portbench import yardstick as Y  # noqa: E402


def test_percentile_interpolates_between_ranks():
    values = list(range(1, 101))  # 1..100
    assert Y.percentile(values, 50) == 50.5
    assert Y.percentile(values, 95) == pytest.approx(95.05)
    assert Y.percentile([7.0], 95) == 7.0
    assert Y.percentile([3, 1, 2], 50) == 2


def test_spread_uses_pythons_quartiles():
    values = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert Y.spread(values) == (q3 - q1) / med


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert Y.union_length(iv) == 3 + 1 + 1
    assert Y.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert Y.gaps(iv, 1, 5.5) == [(3, 5)]
    assert Y.union_length([]) == 0


def test_conv_work_and_bound():
    flop, nbytes = Y.conv_work(pairs=1000, n_in=100, n_out=50, volume=27, cin=32, cout=64, part="fwd")
    assert flop == 2 * 1000 * 32 * 64
    assert nbytes == 4 * (100 * 32 + 27 * 32 * 64 + 50 * 64)
    _, dw_bytes = Y.conv_work(1000, 100, 50, 27, 32, 64, "dw")
    assert dw_bytes == nbytes
    assert Y.bound_s(495e12, 1.0) == 1.0  # operations bound
    assert Y.bound_s(1.0, 3.35e12) == 1.0  # bytes bound


def test_worst_leaf_gap_floors_at_the_median_leaf():
    theirs = {"a": 1.0, "b": 2.0, "c": 1e-6}
    ours = {"a": 1.0, "b": 2.2, "c": 2e-6}
    # c's gap of 1e-6 counts against the median leaf's norm (1.0), not its own
    assert Y.worst_leaf_gap(ours, theirs) == pytest.approx(0.1)
    assert Y.worst_leaf_gap(ours, theirs, keep={"a", "c"}) == pytest.approx(1e-6)


def _event(name, ts, dur, cat="user_annotation", corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read_trace_attributes_kernels_by_launch_range():
    P = tracing.PREFIX
    events = [
        _event(P + "step", 0, 100),
        _event(P + "forward", 0, 60),
        _event(P + "conv.fwd", 10, 20),
        _event(P + "coords.kernel_map", 12, 4),
        _event("cudaLaunchKernel", 13, 1, "cuda_runtime", 1),  # inside coords: not conv
        _event("cudaLaunchKernel", 20, 1, "cuda_runtime", 2),  # conv
        _event("cudaLaunchKernel", 40, 1, "cuda_runtime", 3),  # outside conv
        _event("k_map", 15, 5, "kernel", 1),
        _event("k_conv", 25, 10, "kernel", 2),
        _event("k_other", 50, 10, "kernel", 3),
    ]
    r = tracing.read_trace(events)
    assert r["conv_device_s"] == pytest.approx(10e-6)
    assert r["busy_s"] == pytest.approx(25e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["device_ops"] == 3
    gaps = dict(r["breakdown"]["idle_gaps"])
    # gaps: 0-15 (mid 7.5: forward), 20-25 (mid 22.5: conv.fwd), 35-50 (forward), 60-100
    assert gaps["forward"] == pytest.approx(30e-6)
    assert gaps["conv.fwd"] == pytest.approx(5e-6)
    assert gaps["between steps"] == pytest.approx(40e-6)
