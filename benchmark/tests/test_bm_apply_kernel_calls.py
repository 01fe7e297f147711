"""The reader of the 10 m apply kernel's counter
(``metrics/apply_kernel_calls.py``): on hand-made records, where no span
holds the counter, and in a traced CPU run (the CPU keeps the eager
ops, so it reads nothing there)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans
from benchmark.harness.manifest import Manifest

from conftest import run_small

NAME = "apply_kernel_calls"


def reader():
    m = Manifest()
    return m.reader(next(x for x in m.data["per_layer"] if x["name"] == NAME))


def call(trace, start, apply_counts):
    """One plan call's records: the root and its ``fused.apply`` stage."""
    return [SimpleNamespace(name="fused", span_id=trace, parent_id=None,
                            trace_id=trace, start_s=start, ms=50.0,
                            counts={}),
            SimpleNamespace(name="fused.apply", span_id=trace + 1,
                            parent_id=trace, trace_id=trace,
                            start_s=start + 1, ms=1.0, counts=apply_counts)]


@pytest.fixture
def ctx():
    return SimpleNamespace(window=SimpleNamespace(opened=5.0))


@pytest.mark.parametrize("counts,want", [
    (({"apply.kernel": 1}, {"apply.kernel": 1}), 1.0),
    (({"apply.kernel": 1}, {"apply.kernel": 2}, {}), 1.0),
    (({}, {}), None),
])
def test_reader_on_hand_made_records(monkeypatch, ctx, counts, want):
    recs = [r for i, c in enumerate(counts)
            for r in call(10 * (i + 1), 10.0 + i, c)]
    # an earlier run's call, before the window opened: left out
    recs += call(100, 1.0, {"apply.kernel": 7})
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    got = reader().read(ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_reader_returns_none_without_records(monkeypatch, ctx):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert reader().read(ctx) is None


def test_metric_is_listed_for_the_plan_cell_alone():
    m = Manifest()
    entry = next(x for x in m.data["per_layer"] if x["name"] == NAME)
    assert entry["workloads"] == ["rgb10.resident"]
    assert entry["moves"] == "granule_s"
    assert entry["source"] == "program_counter"
    apply_ms = next(x for x in m.data["per_layer"]
                    if x["name"] == "plan.apply_ms")
    assert entry["layer"] == apply_ms["layer"]


def test_traced_cpu_run_leaves_the_metric_out():
    res = run_small("rgb10.resident", seconds=0.1, trace=True)
    assert NAME not in res["metrics"]
    assert "plan.apply_ms" in res["metrics"]
    assert res["correct"] is True
