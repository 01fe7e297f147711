"""The port's spans and counters (``hyperres_torch.utils.profiling``):
off, a span makes no torch call and leaves no record; on (a
``torch.profiler`` recording, or ``tracing()``), one call of the fused
granule plan, of the SR model and of the resident coregistration core
leaves one span per stage, with the parents and the one trace id of the
call; the Sinkhorn sweep counter ``ot.sweeps`` equals the sweeps run,
and the coregistration's ``coreg.windows`` and ``coreg.tiepoints`` the
windows matched and the tie points used."""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hyperres_torch.core.config import OTConfig, PolyFusionConfig, RidgeSRConfig  # noqa: E402
from hyperres_torch.fusion import fused as tfused  # noqa: E402
from hyperres_torch.fusion import ridge_sr as tridge  # noqa: E402
from hyperres_torch.kernels import sinkhorn as tsink  # noqa: E402
from hyperres_torch.kernels import sinkhorn_duals as tduals  # noqa: E402
from hyperres_torch.spectral.srf_tables import builtin_srf  # noqa: E402
from hyperres_torch.testing.bench_scene import generate_scene  # noqa: E402
from hyperres_torch.utils import profiling  # noqa: E402

#: every test of the plan runs 20 sweeps: a violation is never below 0
OT = OTConfig(n_samples=200, num_itermax=20, stop_thr=-1.0)
STAGES = ("fused.warp", "fused.synth", "fused.stretch", "fused.fit",
          "fused.apply")


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def scene():
    return generate_scene(0.05, 0)


def _srf():
    return builtin_srf("S2A", bands=["B2", "B3", "B4"])


@pytest.fixture(scope="module")
def plan(scene):
    p = tfused.FusedOrthoFusionPlan(
        scene["ortho_grid"], scene["utm60"], scene["s2_grid"],
        scene["raw"].shape[:2], scene["glt"], scene["wavelengths"],
        scene["good_mask"], s2_nodata=65535.0, s2_scale=1e-4,
        config=PolyFusionConfig(ot=OT), srf=_srf(), device="cpu")
    return p, p.prepare_s2(scene["s2_dn"])


def run_plan(plan, scene):
    p, s2 = plan
    return p(scene["raw"], s2)


@pytest.fixture(scope="module")
def sr_data():
    rng = np.random.default_rng(3)
    X = rng.random((300, 4)).astype(np.float32)
    Y = np.clip(0.3 + 0.4 * X[:, :3], 0.01, 0.99).astype(np.float32)
    cube = rng.random((4, 8, 9)).astype(np.float32)
    return X, Y, cube


def run_sr(sr_data):
    X, Y, cube = sr_data
    model = tridge.RidgeSpectralSR(4, 3, RidgeSRConfig(degree=2),
                                   device="cpu").fit(X, Y)
    return model.predict_cube_u16(cube, nodata=-9999.0)


@contextlib.contextmanager
def spans_on(mode):
    if mode == "profiler":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield prof
    else:
        with profiling.tracing():
            yield None


def by_name(recs):
    out = {}
    for r in recs:
        assert r.name not in out, f"{r.name} twice"
        out[r.name] = r
    return out


# ------------------------------------------------------------------ off ---

def test_off_span_makes_no_torch_call_and_leaves_no_record(
        monkeypatch, plan, scene, sr_data):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling.span("fused") is profiling.span("sr.fit")
    with profiling.span("fused", "cpu"):
        profiling.count("ot.sweeps", 5)
    run_plan(plan, scene)
    run_sr(sr_data)
    assert profiling.records() == []


# ------------------------------------------------------------------- on ---

@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_plan_call_spans_parents_and_trace_id(mode, plan, scene):
    with spans_on(mode) as prof:
        run_plan(plan, scene)
    recs = by_name(profiling.records())
    assert set(recs) == {"fused", *STAGES}
    root = recs["fused"]
    assert root.parent_id is None and root.trace_id == root.span_id
    for name in STAGES:
        r = recs[name]
        assert r.parent_id == root.span_id and r.trace_id == root.span_id
        assert root.start_s <= r.start_s <= r.end_s <= root.end_s
        assert r.device_ms is None and r.ms == pytest.approx(r.host_ms)
    # the stages run in the plan's order, one after the other
    starts = [recs[n].start_s for n in STAGES]
    assert starts == sorted(starts)
    # the counter lands in the OT fit, and equals the sweeps run
    assert recs["fused.fit"].counts == {"ot.sweeps": OT.num_itermax}
    assert all(not recs[n].counts for n in recs if n != "fused.fit")
    if prof is not None:
        names = {e.name for e in prof.events()}
        assert {"fused", *STAGES} <= names


@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_fusion_plan_alone_is_its_own_root(mode, scene, plan):
    """``FusedFusionPlan`` opens ``fused`` itself (its four stages, no
    warp); two calls give two traces."""
    p, s2 = plan
    utm = p.warp(scene["raw"])
    with spans_on(mode):
        p._fusion(utm, s2)
        p._fusion(utm, s2)
    recs = profiling.records()
    roots = [r for r in recs if r.parent_id is None]
    assert [r.name for r in roots] == ["fused", "fused"]
    assert roots[0].trace_id != roots[1].trace_id
    for root in roots:
        kids = [r.name for r in recs if r.parent_id == root.span_id]
        assert kids == list(STAGES[1:])


@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_sr_fit_and_predict_spans(mode, sr_data):
    with spans_on(mode):
        q = run_sr(sr_data)
    assert q.shape == (3, 8, 9)
    recs = by_name(profiling.records())
    assert set(recs) == {"sr.fit", "sr.predict", "sr.predict.kernel"}
    fit, pred, kern = (recs[n] for n in ("sr.fit", "sr.predict",
                                         "sr.predict.kernel"))
    assert fit.parent_id is None and fit.trace_id == fit.span_id
    assert pred.parent_id is None and pred.trace_id == pred.span_id
    assert kern.parent_id == pred.span_id and kern.trace_id == pred.span_id
    assert fit.end_s <= pred.start_s <= kern.start_s <= kern.end_s <= pred.end_s


@pytest.mark.parametrize("num_itermax,stop_thr,sweeps", [
    (30, -1.0, 30),    # never met: every sweep up to num_itermax
    (300, 1e9, 10),    # met at the first test, after check_every sweeps
    (0, 0.0, 0),
])
@pytest.mark.parametrize("route", ["sinkhorn_log", "duals"])
def test_sweep_counter_equals_the_sweeps_run(route, num_itermax, stop_thr,
                                             sweeps):
    gen = torch.Generator().manual_seed(1)
    X, Y = torch.rand(12, 3, generator=gen), torch.rand(9, 3, generator=gen)
    a, b = torch.full((12,), 1 / 12), torch.full((9,), 1 / 9)
    M = tsink.sqeuclidean_cdist(X, Y)
    with profiling.tracing(), profiling.span("ot") as rec:
        if route == "sinkhorn_log":
            tsink.sinkhorn_log(a, b, M, 0.05, num_itermax=num_itermax,
                               stop_thr=stop_thr)
            ran = sweeps
        else:
            *_, ran = tduals.sinkhorn_duals(
                a.log(), b.log(), -M / 0.05, num_itermax=num_itermax,
                stop_thr=stop_thr, return_sweeps=True)
            assert ran == sweeps
    assert rec.counts == {"ot.sweeps": ran}


def test_debias_counts_both_transports():
    gen = torch.Generator().manual_seed(2)
    X, Y = torch.rand(10, 3, generator=gen), torch.rand(8, 3, generator=gen)
    with profiling.tracing(), profiling.span("ot") as rec:
        tsink.ot_barycentric_targets(X, Y, num_itermax=20, stop_thr=-1.0,
                                     debias=True)
    assert rec.counts == {"ot.sweeps": 40}


@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_span_closes_when_its_body_raises(mode):
    with spans_on(mode) as prof:
        with pytest.raises(KeyError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise KeyError("x")
        # the stack is empty again: the next span is a root
        with profiling.span("after"):
            pass
    recs = by_name(profiling.records())
    assert recs["inner"].parent_id == recs["outer"].span_id
    assert recs["outer"].parent_id is None and recs["after"].parent_id is None
    assert recs["after"].trace_id != recs["outer"].trace_id
    if prof is not None:
        assert {"outer", "inner", "after"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_count_outside_a_span_does_nothing(mode):
    with spans_on(mode):
        profiling.count("ot.sweeps", 7)
        with profiling.span("s") as rec:
            pass
        profiling.count("ot.sweeps", 3)
    assert rec.counts == {}
    assert [r.name for r in profiling.records()] == ["s"]


def test_records_and_clear():
    with profiling.tracing():
        with profiling.span("a"):
            profiling.count("n")
            profiling.count("n", 2)
    (r,) = profiling.records()
    assert r.counts == {"n": 3} and r.end_s >= r.start_s
    # a copy: the caller's list is not the store
    profiling.records().clear()
    assert len(profiling.records()) == 1
    profiling.clear()
    assert profiling.records() == []
    # tracing() nests, and spans are off again after it
    with profiling.tracing():
        with profiling.tracing():
            pass
        assert profiling.span("x") is not profiling.span("y")
    assert profiling.span("x") is profiling.span("y")


def test_profile_trace_clears_and_exports_the_spans(tmp_path, plan, scene):
    with profiling.tracing(), profiling.span("stale"):
        pass
    with profiling.profile_trace(str(tmp_path)):
        run_plan(plan, scene)
    assert [r.name for r in profiling.records()
            if r.parent_id is None] == ["fused"]
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"fused", *STAGES} <= names


# -------------------------------------------------------- coregistration ---

COREG_STAGES = ("coreg.resample", "coreg.match", "coreg.filter",
                "coreg.deshift")


@pytest.fixture(scope="module")
def coreg_data():
    """The coregistration cell's world over a 100 x 110 raw swath: the
    EMIT band and one displaced 4-band u16 S2 stack (733 x 757 px)."""
    from benchmark.harness.coreg_scene import coreg_scene
    from benchmark.systems.coreg_local import _grid
    from hyperres_torch.core.config import CoregConfig
    from hyperres_torch.coreg.granule import s2_bandmap_from_descriptions

    sc = coreg_scene([100, 110], 1, 2**33 + 3, torch.device("cpu"), bands=4)
    return {"emit": sc["emit"], "stack": sc["stacks"][0],
            "grids": (_grid(sc["utm60"]), _grid(sc["s2_grid"])),
            "bandmap": s2_bandmap_from_descriptions(sc["descriptions"]),
            "config": CoregConfig(window_size=(128, 128), grid_res=150.0,
                                  min_reliability=25.0)}


def run_coreg(d):
    from hyperres_torch.coreg.granule import coregister_stack

    out = coregister_stack({"B08": d["emit"]}, d["grids"][0], d["stack"],
                           d["grids"][1], d["config"],
                           s2_bandmap=d["bandmap"], nodata_emit=-9999.0,
                           nodata_s2=65535.0, device="cpu")
    assert out["final"]["success"]
    return out


@pytest.mark.parametrize("mode", ["profiler", "tracing"])
def test_coreg_spans_nest_under_one_root(mode, coreg_data):
    """One call: the root ``coreg`` and its four stages, in order, under
    one trace id; the stages and the root's self time add up to the
    root; the counters equal the result's windows matched and tie points
    used."""
    from benchmark.harness import program_spans

    with spans_on(mode) as prof:
        out = run_coreg(coreg_data)
    call = profiling.records()
    recs = by_name(call)
    assert set(recs) == {"coreg", *COREG_STAGES}
    root = recs["coreg"]
    assert root.parent_id is None and root.trace_id == root.span_id
    for name in COREG_STAGES:
        r = recs[name]
        assert r.parent_id == root.span_id and r.trace_id == root.span_id
        assert root.start_s <= r.start_s <= r.end_s <= root.end_s
    starts = [recs[n].start_s for n in COREG_STAGES]
    assert starts == sorted(starts)
    stages = sum(program_spans.stage_ms(call, n) for n in COREG_STAGES)
    own = program_spans.self_ms(call)
    assert 0.0 <= own < root.ms
    assert stages + own == pytest.approx(root.ms)
    info = out["result"].info
    assert recs["coreg.match"].counts == {"coreg.windows": info["n_matched"]}
    assert recs["coreg.filter"].counts == {
        "coreg.tiepoints": info["n_used"]}
    assert all(not recs[n].counts for n in ("coreg", "coreg.resample",
                                             "coreg.deshift"))
    if prof is not None:
        assert {"coreg", *COREG_STAGES} <= {e.name for e in prof.events()}


def test_coreg_calls_are_separate_traces(coreg_data):
    with profiling.tracing():
        run_coreg(coreg_data)
        run_coreg(coreg_data)
    roots = [r for r in profiling.records() if r.parent_id is None]
    assert [r.name for r in roots] == ["coreg", "coreg"]
    assert roots[0].trace_id != roots[1].trace_id


def test_coreg_off_records_nothing(monkeypatch, coreg_data):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    run_coreg(coreg_data)
    assert profiling.records() == []
