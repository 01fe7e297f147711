"""The roofline counts at small shapes, by hand, and the least-time
arithmetic."""

import pytest

from benchmark.harness.manifest import ROOT, load_module
from benchmark.harness.peaks import (PEAK_BYTES_S, PEAK_F32_FLOPS,
                                     PEAK_TF32_TC_FLOPS, bound)

METRICS = ROOT / "benchmark" / "metrics"


def reader(name):
    return load_module(METRICS / f"{name}.py", "t_" + name.replace(".", "_"))


def test_bound_takes_the_larger_time():
    b = bound(3.35e12, 1.0, PEAK_F32_FLOPS)
    assert b["bound_s"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = bound(1.0, 2 * PEAK_F32_FLOPS, PEAK_F32_FLOPS)
    assert b["bound_s"] == pytest.approx(2.0) and b["bound_by"] == "operations"


def test_plan_counts():
    shapes = {"raw_hwb": (2, 3, 4), "ortho_hw": (5, 6), "utm_hw": (7, 8),
              "s2_hw": (42, 48)}
    n_bytes, flops = reader("plan.roofline_pct").counts(shapes)
    n_utm, n10 = 7 * 8, 42 * 48
    assert n_bytes == 4 * (2 * 3 * 4 + 3 * n10 + n_utm * 4 + 3 * n_utm
                           + 3 * n10 + 15)
    assert flops == 8 * 5 * (5 * 8 + 7 * 8) + 2 * 4 * 3 * n_utm \
        + n10 * (32 + 24)


def test_scanline_counts():
    shapes = {"raw_hwb": (2, 3, 4), "ortho_hw": (5, 6), "utm_hw": (7, 8)}
    n_bytes, flops = reader("scanline_warp.roofline_pct").counts(shapes)
    c = 5
    p1 = 5 * 6 * c + 5 * 8 + 5 * 8 * c
    p2 = 5 * 8 * c + 7 * 8 + 7 * 8 * c
    assert n_bytes == 4 * (p1 + p2)
    assert flops == 8 * (5 * 8 * c + 7 * 8 * c)


def test_sr_counts_and_its_peak():
    shapes = {"px": 100, "valid_px": 95, "bands_in": 10, "bands_out": 32,
              "features": 285}
    mod = reader("sr_predict.roofline_pct")
    n_bytes, flops = mod.counts(shapes)
    assert n_bytes == 100 * (40 + 64)
    assert flops == 2 * 95 * 285 * 32
    # at the cell's size the operations bound it, at the TF32 peak
    full = {"px": 9140 * 9309, "valid_px": 9140 * 9309 - 9140 * 9309 // 20,
            "bands_in": 10, "bands_out": 32, "features": 285}
    b = bound(*mod.counts(full), PEAK_TF32_TC_FLOPS)
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(2.9766e-3, rel=1e-3)


def test_granule_plan_bound_at_the_cell_size():
    shapes = {"raw_hwb": (1242, 1280, 285), "ortho_hw": (1510, 1534),
              "utm_hw": (1523, 1550), "s2_hw": (9140, 9309)}
    n_bytes, flops = reader("plan.roofline_pct").counts(shapes)
    b = bound(n_bytes, flops, PEAK_F32_FLOPS)
    assert b["bound_by"] == "bytes"
    assert n_bytes / PEAK_BYTES_S == pytest.approx(1.9623e-3, rel=1e-3)


class Ctx:
    def __init__(self, trace, shapes):
        self.trace, self.shapes, self.power_limit_w = trace, shapes, 700.0
        self.log = lambda m: None


def test_a_kernel_roofline_is_silent_without_its_kernel():
    from benchmark.harness.devtrace import TraceSummary

    t = TraceSummary(window_s=1.0, busy_s=0.5, requests=2,
                     kernel_s={"other_kernel": 0.1})
    shapes = {"px": 100, "valid_px": 95, "bands_in": 10, "bands_out": 32,
              "features": 285}
    assert reader("sr_predict.roofline_pct").read(Ctx(t, shapes)) is None
    t.kernel_s["void sr_predict_tc_kernel<4>(float const*)"] = 2.0
    v = reader("sr_predict.roofline_pct").read(Ctx(t, shapes))
    n_bytes, flops = reader("sr_predict.roofline_pct").counts(shapes)
    want = bound(n_bytes, flops, PEAK_TF32_TC_FLOPS)["bound_s"] / 1.0
    assert v == pytest.approx(100 * want)
