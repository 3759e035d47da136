"""The reduction of a profiled stretch: busy time as the union of device
intervals, kernel time without copies, idle gaps labelled by the host."""
from __future__ import annotations

import pytest

from benchmark.trace import summarize


def test_summarize():
    ev = [
        ("bench:stretch", False, 0.0, 100.0),
        ("stage:host_pack", False, 10.0, 40.0),
        ("bench:request", False, 0.0, 100.0),
        ("bench:read_on", False, 60.0, 95.0),
        ("stage:host_pack", True, 10.0, 40.0),   # an annotation: no work
        ("k1", True, 0.0, 10.0),
        ("k1", True, 5.0, 8.0),                  # overlaps the first
        ("Memcpy HtoD", True, 40.0, 50.0),
        ("k2", True, 90.0, 120.0),               # runs past the stretch
    ]
    s = summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)          # 0-10, 40-50, 90-100
    assert s["kernel_s"] == pytest.approx(23e-6)        # 10 + 3 + 10
    assert s["device_ops"][0] == ["k1", pytest.approx(13e-6)]
    gaps = s["idle_gaps"]
    assert gaps[0] == ["bench:read_on", pytest.approx(40e-6)]   # 50-90
    assert gaps[1] == ["host_pack", pytest.approx(30e-6)]       # 10-40


def test_gap_outside_any_benchmark_range_is_the_requests():
    ev = [("bench:stretch", False, 0.0, 10.0),
          ("bench:request", False, 0.0, 10.0),
          ("k", True, 0.0, 2.0)]
    assert summarize(ev)["idle_gaps"] == [["bench:request",
                                           pytest.approx(8e-6)]]


def test_summarize_without_device_work():
    assert summarize([("bench:stretch", False, 0.0, 1.0)]) is None
