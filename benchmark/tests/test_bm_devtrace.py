"""The reduction of a Chrome trace to busy time, kernel time and idle
gaps named by the benchmark's spans."""

import pytest

from benchmark.harness.devtrace import summarize


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize():
    trace = {"traceEvents": [
        ev("user_annotation", "plan", 0, 1000),
        ev("user_annotation", "readback", 1000, 500),
        ev("cpu_op", "aten::item", 300, 200),
        ev("kernel", "k_a", 100, 200),
        ev("kernel", "k_a", 250, 50),      # overlaps the first
        ev("gpu_memcpy", "Memcpy DtoH", 1200, 100),
        ev("kernel", "k_b", 1400, 1000),   # runs past the slice's end
        ev("kernel", "k_c", -50, 20),      # before the slice
    ]}
    s = summarize(trace, 0.0, 1500.0, {"plan", "readback"}, requests=1)
    assert s.window_s == pytest.approx(1.5e-3)
    assert s.busy_s == pytest.approx((200 + 100 + 100) * 1e-6)
    assert s.kernel_s["k_a"] == pytest.approx(250e-6)
    assert s.kernel_s["k_b"] == pytest.approx(100e-6)
    assert "k_c" not in s.kernel_s
    assert s.idle_pct() == pytest.approx(100 * (1 - 0.4 / 1.5))
    # longest gap: 300 .. 1200 us, begun inside plan's aten::item
    assert s.idle_gaps[0][0] == "plan/aten::item"
    assert s.idle_gaps[0][1] == pytest.approx(900e-6)
    assert {g[0] for g in s.idle_gaps} == {"plan/aten::item", "plan",
                                           "readback"}
    assert s.kernel_seconds(("k_a",)) == pytest.approx(250e-6)
    assert s.kernel_seconds(("none",)) is None
