"""The ortho export cell ``ortho60.resident`` on the CPU at a small size
(a 90 x 96 raw swath of 24 bands, OBS ranges from a stride of 8): the
adapter's sound runs, the planted faults that turn ``correct`` false, the
readers of its spans, counters and rooflines, and the calibration's
control."""

import copy
from types import SimpleNamespace

import pytest
import torch

from benchmark.calibrate import run_seed
from benchmark.harness import program_spans
from benchmark.harness.manifest import Manifest
from benchmark.systems import ortho_export

from conftest import run_small, small_manifest

CELL = "ortho60.resident"
SMALL_RAW = [90, 96, 24]
STAGES = ("data", "loc", "obs", "u16")
READERS = ("ortho.data_ms", "ortho.loc_ms", "ortho.obs_ms", "ortho.u16_ms",
           "ortho.self_ms", "ortho_bands")
SHAPES = {"raw_hwb": (1242, 1280, 285), "loc_bands": 3, "obs_bands": 11,
          "ortho_hw": (1510, 1534), "utm_hw": (1523, 1550)}


def ortho_manifest():
    """:func:`conftest.small_manifest` with the ortho cell cut to the
    CPU's size (its limits of ``correct`` kept)."""
    m = small_manifest()
    config = m.config

    def small_config(cell):
        cfg = config(cell)
        if cell["name"] == CELL:
            cfg = copy.deepcopy(cfg)
            cfg["sizes"] = {"raw_hwb": SMALL_RAW}
            cfg["ortho"]["obs_sample_stride"] = 8
        return cfg

    m.config = small_config
    return m


def run_ortho(trace=False, system_factory=None, seconds=0.3):
    return run_small(CELL, seconds=seconds, trace=trace, m=ortho_manifest(),
                     system_factory=system_factory)


def with_fault(fault):
    from hyperres_torch.kernels.stats import quantize_u16
    from hyperres_torch.ortho import products

    class Broken(ortho_export.System):
        def request(self, i):
            sc = self.scene
            if fault == "mask_ignored":
                saved = self.qmask
                self.qmask = None
            elif fault == "lat_lon_swapped":
                saved = sc["loc"]
                sc["loc"] = saved[..., [1, 0, 2]].contiguous()
            try:
                super().request(i)
            finally:
                if fault == "mask_ignored":
                    self.qmask = saved
                elif fault == "lat_lon_swapped":
                    sc["loc"] = saved
            out = self.last["out"]
            if fault == "obs_full_cube":
                out.obs_u16, out.decode["obs"] = products.obs_u16(
                    out.obs, sample_stride=1,
                    percentiles=self.config.obs_percentiles)
            elif fault == "data_to_65535":
                out.data_u16 = quantize_u16(out.data, 0.0, 1.0,
                                            nodata_u16=65535,
                                            nodata_src=-9999.0)
    return Broken


def test_sound_runs_are_correct():
    res = run_ortho()
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    m = Manifest()
    assert set(res["compared"]) == set(
        m.config(m.cell(CELL))["correct"]["limits"])
    assert set(res["metrics"]) == {"granule_s", "granule_p95_s", "setup_s"}


@pytest.mark.parametrize("fault,reading", [
    ("mask_ignored", "utm_mask"), ("obs_full_cube", "obs_range_gap"),
    ("data_to_65535", "u16_steps"), ("lat_lon_swapped", "aux_gap")])
def test_faults_turn_correct_false(fault, reading):
    res = run_ortho(system_factory=with_fault(fault))
    assert res["correct"] is False, (fault, res["compared"])
    c = res["compared"][reading]
    assert c["value"] > c["limit"], (fault, res["compared"])


def test_traced_run_reports_every_new_metric():
    res = run_ortho(trace=True, seconds=0.1)
    m = Manifest()
    names = {x["name"] for x in m.per_layer(m.cell(CELL))}
    assert set(READERS) | {"ortho.roofline_pct", "quantize_kernel_calls",
                           "quantize_u16.roofline_pct",
                           "device_idle_pct.ortho60"} == names
    for name in READERS + ("ortho.roofline_pct",):
        assert res["metrics"][name]["value"] >= 0, name
    assert res["metrics"]["ortho_bands"]["value"] == SMALL_RAW[2] + 3 + 11
    # the CPU launches no quantize kernel, and has no device trace
    assert "quantize_kernel_calls" not in res["metrics"]
    assert "quantize_u16.roofline_pct" not in res["metrics"]
    assert res["correct"] is True


def rec(name, sid, parent, trace, ms, start, counts=None):
    return SimpleNamespace(name=name, span_id=sid, parent_id=parent,
                           trace_id=trace, start_s=start, ms=ms,
                           counts=counts or {})


def ortho_call(trace, stages_ms, root_ms, start, quant=4):
    out = [rec("ortho", trace, None, trace, root_ms, start)]
    bands = {"data": 285, "loc": 3, "obs": 11}
    for k, (name, ms) in enumerate(zip(STAGES, stages_ms)):
        counts = ({"ortho.bands": bands[name]} if name in bands
                  else {"quantize.kernel": quant} if quant else None)
        out.append(rec(f"ortho.{name}", trace + 1 + k, trace, trace, ms,
                       start + k, counts))
    return out


def reader(name):
    m = Manifest()
    return m.reader(next(x for x in m.data["per_layer"] if x["name"] == name))


def ctx_of(**kw):
    return SimpleNamespace(window=SimpleNamespace(opened=5.0), shapes=SHAPES,
                           power_limit_w=700.0, log=lambda msg: None, **kw)


def test_readers_on_hand_made_records(monkeypatch):
    recs = (ortho_call(1, (20.0, 1.0, 2.0, 3.0), 27.0, 10.0)
            + ortho_call(7, (21.0, 1.5, 2.5, 3.5), 29.5, 20.0)
            + ortho_call(13, (22.0, 2.0, 3.0, 4.0), 32.0, 30.0)
            # an earlier run's call, before this window opened
            + ortho_call(19, (1.0, 1.0, 1.0, 1.0), 5.0, 1.0, quant=9))
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    ctx = ctx_of()
    want = {"ortho.data_ms": 21.0, "ortho.loc_ms": 1.5, "ortho.obs_ms": 2.5,
            "ortho.u16_ms": 3.5,
            # per call: 27 - 26, 29.5 - 28.5, 32 - 31
            "ortho.self_ms": 1.0, "ortho_bands": 299.0,
            "quantize_kernel_calls": 4.0}
    for name, value in want.items():
        assert reader(name).read(ctx) == pytest.approx(value), name
    n_bytes, _ = reader("ortho.roofline_pct").counts(SHAPES)
    assert reader("ortho.roofline_pct").read(ctx) == pytest.approx(
        100 * n_bytes / 3.35e12 / 0.0295)


def test_quantize_calls_none_where_no_span_holds_the_counter(monkeypatch):
    recs = ortho_call(1, (20.0, 1.0, 2.0, 3.0), 27.0, 10.0, quant=0)
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    assert reader("quantize_kernel_calls").read(ctx_of()) is None
    assert reader("ortho_bands").read(ctx_of()) == 299.0


@pytest.mark.parametrize("name", READERS + ("ortho.roofline_pct",
                                            "quantize_kernel_calls"))
def test_readers_return_none_without_records(monkeypatch, name):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert reader(name).read(ctx_of()) is None


def test_quantize_roofline_on_a_recorded_trace():
    """The kernel's seconds per request against each product's float32
    read and u16 write: 6 bytes a code of 1523 x 1550 x 300."""
    got = reader("quantize_u16.roofline_pct")
    trace = SimpleNamespace(
        requests=20, kernel_seconds=lambda names: 20 * 1.6e-3
        if names == ("quantize_kernel",) else None)
    n = 1523 * 1550 * 300
    assert got.counts(SHAPES) == (6.0 * n, 4.0 * n)
    assert got.read(ctx_of(trace=trace)) == pytest.approx(
        100 * 6.0 * n / 3.35e12 / 1.6e-3)
    assert got.read(ctx_of(trace=None)) is None
    none = SimpleNamespace(requests=20, kernel_seconds=lambda names: None)
    assert got.read(ctx_of(trace=none)) is None


def test_roofline_counts_at_the_cell_size():
    """The bytes bound it: the raw cubes in, the float32 UTM cubes and the
    u16 codes out (6.1 GB), against 11.2 GFLOP of two 4-tap passes."""
    n_bytes, flops = reader("ortho.roofline_pct").counts(SHAPES)
    hd, wd = SHAPES["utm_hw"]
    assert n_bytes == (4.0 * 1242 * 1280 * 299 + 4.0 * hd * wd * 299
                       + 2.0 * hd * wd * 300)
    assert flops == 8.0 * (1510 * wd + hd * wd) * 299
    assert n_bytes / 3.35e12 > flops / 67e12


def test_metrics_listed_for_the_ortho_cell_alone():
    m = Manifest()
    for x in m.data["per_layer"]:
        if x["name"] in READERS or x["name"].startswith(("ortho", "quantize")):
            assert x["workloads"] == [CELL] and x["moves"] == "granule_s"
    for x in m.data["end_to_end"]:
        if x["name"] in ("granule_s", "granule_p95_s"):
            assert CELL in x["workloads"]


def test_calibration_reads_the_control():
    """On the CPU at a small size: the program's readings are those the
    run compared, and the control (TF32 in the warp's products, which the
    CPU does not take) reads the reference's own numbers."""
    line = run_seed(ortho_manifest(), CELL, 2**33 + 21, 0.3,
                    torch.device("cpu"), control=True)
    assert line["correct"] is True and line["requests"] >= 1
    assert set(line["control"]) == set(line["program"])


@pytest.mark.gpu
def test_control_fails_where_the_program_passes_on_the_card(cuda):
    """At the cell's size on the card: the program passes every limit,
    the control fails at least one."""
    from benchmark.harness.compare import checks

    m = Manifest()
    limits = m.config(m.cell(CELL))["correct"]["limits"]
    line = run_seed(m, CELL, 2**33 + 31, 0.5, cuda, control=True)
    assert line["correct"] is True, line["program"]
    assert not all(x.ok for x in checks(line["control"], limits))
