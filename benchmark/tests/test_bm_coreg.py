"""The coregistration cell ``coreg10.resident`` on the CPU at a small size
(a 170 x 180 raw swath, 4 bands, 128 px windows every 150 px): the
adapter's sound runs, the planted faults that turn ``correct`` false,
the readers of its spans and counters, its roofline counts and the
calibration's control."""

import copy

import pytest
import torch

from benchmark.calibrate import run_seed
from benchmark.harness import program_spans
from benchmark.harness.manifest import Manifest
from benchmark.harness.scene import swath_geometry
from benchmark.systems import coreg_local

from conftest import run_small, small_manifest

CELL = "coreg10.resident"
SMALL_SWATH = [170, 180]
READERS = ("coreg.resample_ms", "coreg.match_ms", "coreg.filter_ms",
           "coreg.deshift_ms", "coreg.self_ms", "coreg_windows",
           "coreg_tiepoints")
STAGES = ("resample", "match", "filter", "deshift")


def coreg_manifest():
    """:func:`conftest.small_manifest` with the coregistration cell cut
    to the CPU's size (its limits of ``correct`` kept)."""
    m = small_manifest()
    config = m.config
    geo = swath_geometry(*SMALL_SWATH)

    def small_config(cell):
        cfg = config(cell)
        if cell["name"] == CELL:
            cfg = copy.deepcopy(cfg)
            cfg["sizes"].update(swath_raw_hw=SMALL_SWATH, bands=4,
                                utm_hw=list(geo["utm60"].shape),
                                s2_hw=list(geo["s2_grid"].shape))
            cfg["coreg"].update(window_size=[128, 128], grid_res=150.0,
                                min_reliability=25.0)
        return cfg

    m.config = small_config
    return m


def run_coreg(trace=False, system_factory=None, seconds=0.5):
    return run_small(CELL, seconds=seconds, trace=trace, m=coreg_manifest(),
                     system_factory=system_factory)


def with_fault(fault):
    class Broken(coreg_local.System):
        def request(self, i):
            if fault == "stale":
                # the product of another target handed out as this one's
                super().request(i + 1)
                prev = self.last
                super().request(i)
                self.last = dict(self.last, q=prev["q"])
                self.kept = {k: self.last for k in self.kept}
                return
            super().request(i)
            rec = self.last
            if fault == "shift":
                t = next(t for t in rec["result"].tie_points if t.used)
                t.dy += 0.01
            elif fault == "half":
                flat = rec["q"].view(rec["q"].shape[0], -1)
                flat[:, flat.shape[1] // 2:] = 65535
    return Broken


def test_sound_runs_are_correct():
    res = run_coreg()
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["compared"]) == set(
        Manifest().config(Manifest().cell(CELL))["correct"]["limits"])
    assert set(res["metrics"]) == {"granule_s", "granule_p95_s", "setup_s"}


@pytest.mark.parametrize("fault", ["shift", "stale", "half"])
def test_faults_turn_correct_false(fault):
    res = run_coreg(system_factory=with_fault(fault))
    assert res["correct"] is False, (fault, res["compared"])


def test_traced_run_reports_every_new_metric():
    res = run_coreg(trace=True, seconds=0.1)
    m = Manifest()
    names = {x["name"] for x in m.per_layer(m.cell(CELL))}
    assert set(READERS) | {"coreg.roofline_pct",
                           "device_idle_pct.coreg10"} <= names
    for name in READERS:
        assert res["metrics"][name]["value"] >= 0, name
    assert res["metrics"]["coreg_tiepoints"]["value"] >= 10
    assert res["metrics"]["coreg_windows"]["value"] \
        >= res["metrics"]["coreg_tiepoints"]["value"]
    assert res["correct"] is True


def rec(name, sid, parent, trace, ms, start, counts=None):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, span_id=sid, parent_id=parent,
                           trace_id=trace, start_s=start, ms=ms,
                           counts=counts or {})


def coreg_call(trace, stages_ms, root_ms, start, windows, points):
    out = [rec("coreg", trace, None, trace, root_ms, start)]
    for k, (name, ms) in enumerate(zip(STAGES, stages_ms)):
        counts = {"match": {"coreg.windows": windows},
                  "filter": {"coreg.tiepoints": points}}.get(name)
        out.append(rec(f"coreg.{name}", trace + 1 + k, trace, trace, ms,
                       start + k, counts))
    return out


def reader(name):
    m = Manifest()
    return m.reader(next(x for x in m.data["per_layer"] if x["name"] == name))


def test_readers_on_hand_made_records(monkeypatch):
    from types import SimpleNamespace

    ctx = SimpleNamespace(window=SimpleNamespace(opened=5.0),
                          shapes={"s2_hw": (9140, 9309),
                                  "utm_hw": (1523, 1550), "bands": 10,
                                  "window_hw": (512, 512), "windows": 225},
                          power_limit_w=700.0, log=lambda msg: None)
    recs = (coreg_call(1, (10.0, 12.0, 16.0, 600.0), 640.0, 10.0, 158, 150)
            + coreg_call(7, (11.0, 13.0, 15.0, 590.0), 631.0, 20.0, 160, 156)
            + coreg_call(13, (12.0, 14.0, 17.0, 610.0), 655.0, 30.0, 150,
                         148)
            # an earlier run's call, before this window opened
            + coreg_call(19, (1.0, 1.0, 1.0, 1.0), 5.0, 1.0, 1, 1))
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    want = {"coreg.resample_ms": 11.0, "coreg.match_ms": 13.0,
            "coreg.filter_ms": 16.0, "coreg.deshift_ms": 600.0,
            # per call: 640 - 638, 631 - 629, 655 - 653
            "coreg.self_ms": 2.0, "coreg_windows": 156.0,
            "coreg_tiepoints": 454 / 3}
    for name, value in want.items():
        assert reader(name).read(ctx) == pytest.approx(value), name
    # the least time 1.1203 ms (by bytes) over the median root, 640 ms
    assert reader("coreg.roofline_pct").read(ctx) == pytest.approx(
        100 * 3753150040.0 / 3.35e12 / 0.640)


@pytest.mark.parametrize("name", READERS + ("coreg.roofline_pct",))
def test_readers_return_none_without_records(monkeypatch, name):
    from types import SimpleNamespace

    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    ctx = SimpleNamespace(window=SimpleNamespace(opened=0.0), shapes={},
                          power_limit_w=None, log=lambda msg: None)
    assert reader(name).read(ctx) is None


def test_roofline_counts_at_the_cell_size():
    """The bytes bound it: 3.75 GB (the u16 stack in and out, the EMIT
    band in, the 10 m reference band out) against 38.6 GFLOP."""
    counts = reader("coreg.roofline_pct").counts
    n_bytes, flops = counts({"s2_hw": (9140, 9309), "utm_hw": (1523, 1550),
                             "bands": 10, "window_hw": (512, 512),
                             "windows": 225})
    n10 = 9140 * 9309
    assert n_bytes == 40.0 * n10 + 4.0 * 1523 * 1550 + 4.0 * n10
    assert flops == pytest.approx(8.0 * (9140 * 1550 + n10) + 320.0 * n10
                                  + 225 * 10 * 512 * 512 * 18)
    assert n_bytes / 3.35e12 > flops / 67e12


def test_calibration_reads_the_control():
    """On the CPU at a small size: the program's readings are those the
    run compared, and the control (TF32 in the resample, bfloat16
    windows) reads the same numbers; its bfloat16 windows move the
    shifts by more than the program's."""
    line = run_seed(coreg_manifest(), CELL, 2**33 + 21, 0.3,
                    torch.device("cpu"), control=True)
    assert line["correct"] is True and line["requests"] >= 1
    assert set(line["control"]) == set(line["program"])
    assert line["control"]["shift_gap"] > line["program"]["shift_gap"]


@pytest.mark.gpu
def test_control_fails_where_the_program_passes_on_the_card(cuda):
    """At the cell's size on the card (about 1 minute on an H100): the
    program passes every limit, the control fails at least one."""
    from benchmark.harness.compare import checks

    m = Manifest()
    limits = m.config(m.cell(CELL))["correct"]["limits"]
    line = run_seed(m, CELL, 2**33 + 31, 0.5, cuda, control=True)
    assert line["correct"] is True, line["program"]
    assert not all(x.ok for x in checks(line["control"], limits))
