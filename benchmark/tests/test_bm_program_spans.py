"""The readers of the program's own spans and counters
(``harness/program_spans.py``): on hand-made records, without records,
and in traced CPU runs of each cell."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans
from benchmark.harness.devtrace import summarize
from benchmark.harness.manifest import Manifest

from conftest import run_small

#: the readers of the program's spans, by cell
READERS = {
    "rgb10.resident": ("plan.warp_ms", "plan.synth_ms", "plan.stretch_ms",
                       "plan.fit_ms", "plan.apply_ms", "plan.self_ms",
                       "ot_sweeps"),
    "sr10.resident": ("sr_fit.span_ms", "sr_predict.self_ms"),
}
ALL = [name for names in READERS.values() for name in names]


def rec(name, sid, parent, trace, ms, start=10.0, counts=None):
    return SimpleNamespace(name=name, span_id=sid, parent_id=parent,
                           trace_id=trace, start_s=start, ms=ms,
                           counts=counts or {})


def plan_call(trace, first_id, stages_ms, root_ms, start, sweeps=10):
    """Records of one plan call: the root ``fused`` and its five stages."""
    out = [rec("fused", first_id, None, trace, root_ms, start)]
    for k, (name, ms) in enumerate(zip(
            ("warp", "synth", "stretch", "fit", "apply"), stages_ms)):
        out.append(rec(f"fused.{name}", first_id + 1 + k, first_id, trace,
                       ms, start + k,
                       {"ot.sweeps": sweeps} if name == "fit" else None))
    return out


def sr_call(trace, first_id, fit_ms, predict_ms, kernel_ms, start):
    return [rec("sr.fit", first_id, None, trace, fit_ms, start),
            rec("sr.predict", first_id + 1, None, first_id + 1, predict_ms,
                start + 1),
            rec("sr.predict.kernel", first_id + 2, first_id + 1,
                first_id + 1, kernel_ms, start + 2)]


def reader(name):
    m = Manifest()
    return m.reader(next(x for x in m.data["per_layer"] if x["name"] == name))


@pytest.fixture
def ctx():
    return SimpleNamespace(window=SimpleNamespace(opened=5.0))


def test_readers_on_hand_made_records(monkeypatch, ctx):
    recs = (plan_call(1, 1, (30.0, 3.0, 5.0, 6.0, 28.0), 73.0, 10.0)
            + plan_call(7, 7, (34.0, 4.0, 7.0, 8.0, 30.0), 84.0, 20.0, 20)
            + plan_call(13, 13, (40.0, 5.0, 9.0, 10.0, 32.0), 98.0, 30.0)
            # an earlier run's call, before this window opened: left out
            + plan_call(19, 19, (1.0, 1.0, 1.0, 1.0, 1.0), 500.0, 1.0)
            + sr_call(25, 25, 5.0, 40.0, 36.5, 40.0)
            + sr_call(28, 28, 5.5, 41.0, 36.0, 50.0))
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    want = {"plan.warp_ms": 34.0, "plan.synth_ms": 4.0,
            "plan.stretch_ms": 7.0, "plan.fit_ms": 8.0,
            "plan.apply_ms": 30.0,
            # per call: 73 - 72, 84 - 83, 98 - 96
            "plan.self_ms": 1.0, "ot_sweeps": 40 / 3,
            "sr_fit.span_ms": 5.25,
            # per call: 40 - 36.5, 41 - 36
            "sr_predict.self_ms": 4.25}
    for name, value in want.items():
        assert reader(name).read(ctx) == pytest.approx(value), name
    assert len(program_spans.calls(ctx, "fused")) == 3
    # a call whose root is another span is no call of that root
    assert program_spans.calls(ctx, "fused.warp") == []
    # the five stages and the self time add up to the root, per call
    for call in program_spans.calls(ctx, "fused"):
        root = next(r for r in call if r.parent_id is None)
        stages = sum(program_spans.stage_ms(call, f"fused.{s}") for s in
                     ("warp", "synth", "stretch", "fit", "apply"))
        assert stages + program_spans.self_ms(call) == pytest.approx(root.ms)


@pytest.mark.parametrize("name", ALL)
def test_reader_returns_none_without_records(monkeypatch, ctx, name):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert reader(name).read(ctx) is None


def test_a_program_without_span_records_gives_none(monkeypatch, ctx):
    """An older program's profiling module has no ``records``: the
    readers find nothing and raise nothing."""
    from hyperres_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert program_spans.program_records() == []
    assert reader("plan.warp_ms").read(ctx) is None


@pytest.mark.parametrize("cell", sorted(READERS))
def test_traced_cpu_run_reports_every_new_metric(cell):
    res = run_small(cell, seconds=0.1, trace=True)
    m = Manifest()
    assert set(READERS[cell]) <= {x["name"] for x in m.per_layer(m.cell(cell))}
    for name in READERS[cell]:
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] >= 0, name
    if cell == "rgb10.resident":
        assert res["metrics"]["ot_sweeps"]["value"] == 10
    assert res["correct"] is True


def test_busy_time_counts_no_gpu_user_annotation():
    """The program's spans land on the device timeline as
    ``gpu_user_annotation`` ranges; the busy union leaves them out."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "fused",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 200},
    ]}
    s = summarize(trace, 0.0, 1000.0, {"plan"}, requests=1)
    assert s.busy_s == pytest.approx(200e-6)
    assert "fused" not in s.kernel_s
