"""The reader of the fused ortho warp's counter
(``metrics/orthowarp_kernel_calls.py``): on hand-made records of both
roots it reads (the plan's ``fused``, the ortho export's ``ortho``), where
no span holds the counter, and in traced CPU runs of its two cells (the
CPU keeps the plain chain, so it reads nothing there)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans
from benchmark.harness.manifest import Manifest

from conftest import run_small
from test_bm_ortho import run_ortho

NAME = "orthowarp_kernel_calls"
COUNTER = "orthowarp.kernel"
#: each root's warp stages, one fused warp a stage
STAGES = {"fused": ("fused.warp",),
          "ortho": ("ortho.data", "ortho.loc", "ortho.obs")}


def reader():
    m = Manifest()
    return m.reader(next(x for x in m.data["per_layer"] if x["name"] == NAME))


def call(root, trace, start, warp_counts):
    """One call's records: the root, its warp stages (each with
    ``warp_counts``) and one stage without the counter."""
    recs = [SimpleNamespace(name=root, span_id=trace, parent_id=None,
                            trace_id=trace, start_s=start, ms=30.0,
                            counts={})]
    for k, stage in enumerate(STAGES[root]):
        recs.append(SimpleNamespace(
            name=stage, span_id=trace + 1 + k, parent_id=trace,
            trace_id=trace, start_s=start + 0.1 * (k + 1), ms=5.0,
            counts=dict(warp_counts)))
    recs.append(SimpleNamespace(name=f"{root}.other", span_id=trace + 9,
                                parent_id=trace, trace_id=trace,
                                start_s=start + 0.9, ms=1.0,
                                counts={"other.kernel": 2}))
    return recs


@pytest.fixture
def ctx():
    return SimpleNamespace(window=SimpleNamespace(opened=5.0))


@pytest.mark.parametrize("root,counts,want", [
    ("fused", ({COUNTER: 1}, {COUNTER: 1}), 1.0),
    ("fused", ({COUNTER: 1}, {COUNTER: 2}, {}), 1.0),
    ("ortho", ({COUNTER: 1}, {COUNTER: 1}), 3.0),
    ("ortho", ({COUNTER: 1}, {}), 1.5),
    ("fused", ({}, {}), None),
    ("ortho", ({}, {}), None),
])
def test_reader_on_hand_made_records(monkeypatch, ctx, root, counts, want):
    recs = [r for i, c in enumerate(counts)
            for r in call(root, 10 * (i + 1), 10.0 + i, c)]
    # an earlier run's call, before the window opened: left out
    recs += call(root, 100, 1.0, {COUNTER: 7})
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    got = reader().read(ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_reader_returns_none_without_records(monkeypatch, ctx):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert reader().read(ctx) is None


def test_metric_is_listed_for_the_two_warp_cells_alone():
    m = Manifest()
    entry = next(x for x in m.data["per_layer"] if x["name"] == NAME)
    assert entry["workloads"] == ["rgb10.resident", "ortho60.resident"]
    assert entry["moves"] == "granule_s"
    assert entry["source"] == "program_counter"
    warp_ms = next(x for x in m.data["per_layer"]
                   if x["name"] == "plan.warp_ms")
    assert entry["layer"] == warp_ms["layer"]


@pytest.mark.parametrize("cell,stage", [("rgb10.resident", "plan.warp_ms"),
                                        ("ortho60.resident", "ortho.data_ms")])
def test_traced_cpu_run_leaves_the_metric_out(cell, stage):
    if cell == "ortho60.resident":
        res = run_ortho(trace=True, seconds=0.1)
    else:
        res = run_small(cell, seconds=0.1, trace=True)
    assert NAME not in res["metrics"]
    assert stage in res["metrics"]
    assert res["correct"] is True
