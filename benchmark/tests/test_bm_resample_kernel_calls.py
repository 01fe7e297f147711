"""The reader of the resample kernel's counter
(``metrics/resample_kernel_calls.py``): on hand-made records, where no
span holds the counter, and in a traced CPU run of the coregistration
cell (the CPU keeps the dense route, so it reads nothing there)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans
from benchmark.harness.manifest import Manifest

from test_bm_coreg import run_coreg

NAME = "resample_kernel_calls"


def reader():
    m = Manifest()
    return m.reader(next(x for x in m.data["per_layer"] if x["name"] == NAME))


def call(trace, start, resample_counts):
    """One ``coregister_stack`` call's records: the root, its
    ``coreg.resample`` stage and a match."""
    return [SimpleNamespace(name="coreg", span_id=trace, parent_id=None,
                            trace_id=trace, start_s=start, ms=50.0,
                            counts={}),
            SimpleNamespace(name="coreg.resample", span_id=trace + 1,
                            parent_id=trace, trace_id=trace,
                            start_s=start + 0.1, ms=2.0,
                            counts=resample_counts),
            SimpleNamespace(name="coreg.match", span_id=trace + 2,
                            parent_id=trace, trace_id=trace,
                            start_s=start + 0.2, ms=10.0,
                            counts={"coreg.windows": 158})]


@pytest.fixture
def ctx():
    return SimpleNamespace(window=SimpleNamespace(opened=5.0))


@pytest.mark.parametrize("counts,want", [
    (({"resample.kernel": 1}, {"resample.kernel": 1}), 1.0),
    (({"resample.kernel": 1}, {"resample.kernel": 2}, {}), 1.0),
    (({}, {}), None),
])
def test_reader_on_hand_made_records(monkeypatch, ctx, counts, want):
    recs = [r for i, c in enumerate(counts)
            for r in call(10 * (i + 1), 10.0 + i, c)]
    # an earlier run's call, before the window opened: left out
    recs += call(100, 1.0, {"resample.kernel": 7})
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    got = reader().read(ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_reader_returns_none_without_records(monkeypatch, ctx):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert reader().read(ctx) is None


def test_metric_is_listed_for_the_coreg_cell_alone():
    m = Manifest()
    entry = next(x for x in m.data["per_layer"] if x["name"] == NAME)
    assert entry["workloads"] == ["coreg10.resident"]
    assert entry["moves"] == "granule_s"
    assert entry["source"] == "program_counter"
    resample_ms = next(x for x in m.data["per_layer"]
                       if x["name"] == "coreg.resample_ms")
    assert entry["layer"] == resample_ms["layer"]


def test_traced_cpu_run_leaves_the_metric_out():
    res = run_coreg(trace=True, seconds=0.1)
    assert NAME not in res["metrics"]
    assert "coreg.resample_ms" in res["metrics"]
    assert res["correct"] is True
