"""BENCHMARK.json, the files it names, and discovery by name: a new
configuration, traffic mix and per-layer metric are picked up from new
files and manifest entries alone."""

import json
import re

import pytest

from benchmark.harness.manifest import (NAME_RE, UNIT_RE, Manifest,
                                        ManifestError, check_names)

from conftest import ROOT, dummy_checkout, run_small, unchanged

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_cell_names_its_files_and_reports_enough():
    m = Manifest()
    e2e_names = {x["name"] for x in MANIFEST["end_to_end"]}
    for cell in MANIFEST["workloads"]:
        assert cell["chips"] in (1, 4)
        config = m.config(cell)
        traffic = m.traffic(cell)
        assert hasattr(m.system(config, traffic), "System")
        e2e = [x["name"] for x in m.end_to_end(cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        for name in e2e:
            assert name == "setup_s" or name in traffic["end_to_end"]
        layer = m.per_layer(cell)
        assert layer, cell["name"]
        for x in layer:
            assert x["moves"] in e2e and x["moves"] in e2e_names
            assert callable(m.reader(x).read)
        assert config["reduced"] == [] and config["assumed"] == []
    for c in MANIFEST["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_layers_named_alike_and_metrics_listed_in_cells_that_exist():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    by_layer = {}
    for x in MANIFEST["per_layer"]:
        assert set(x["workloads"]) <= cells
        assert "\n" not in x["layer"] and 1 <= len(x["layer"]) <= 200
        by_layer.setdefault(x["layer"], []).append(x["name"])
    assert "Device (one H100)" in by_layer


@pytest.mark.parametrize("name,ok", [
    ("rgb10.resident", True), ("plan.roofline_pct", True), ("_x-1", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("a,b", False), ("a/b", False), (".lead", False), ("µs", False)])
def test_name_characters(name, ok):
    assert bool(NAME_RE.match(name)) == ok


@pytest.mark.parametrize("unit,ok", [
    ("s", True), ("Mpx/s", True), ("%", True), ("tokens/s", True),
    ("tokens per second", False), ("", False), ("x" * 17, False),
    ("µs", False)])
def test_unit_characters(unit, ok):
    assert bool(UNIT_RE.match(unit)) == ok


def test_check_names_refuses_a_bad_or_repeated_name():
    bad = json.loads(json.dumps(MANIFEST))
    bad["workloads"][0]["name"] = "bad name"
    with pytest.raises(ManifestError):
        check_names(bad)
    rep = json.loads(json.dumps(MANIFEST))
    rep["per_layer"].append(dict(rep["per_layer"][0]))
    with pytest.raises(ManifestError):
        check_names(rep)


def test_new_config_mix_and_metric_come_from_new_files_alone(tmp_path):
    path, before = dummy_checkout(tmp_path)
    m = Manifest(path)
    res = run_small("dummy.cell", seconds=0.05, m=m)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"dummy_rate_s", "setup_s"}
    res = run_small("dummy.cell", seconds=0.05, m=m, trace=True)
    assert set(res["metrics"]) >= {"dummy.answer_ms"}
    assert unchanged(tmp_path, before)


def test_a_mix_whose_loop_is_new_code_comes_from_new_files_alone(tmp_path):
    """A mix that needs a request loop of its own names it by its
    ``"system"``: a new adapter file, run on a configuration that is
    already there (whose own adapter does not run)."""
    path, before = dummy_checkout(tmp_path, config="emit_granule_sr10",
                                  loop="dummy_loop")
    m = Manifest(path)
    cell = m.cell("dummy.cell")
    assert m.system(m.config(cell), m.traffic(cell)).__name__ \
        == "benchmark_system_dummy_loop"
    res = run_small("dummy.cell", seconds=0.05, m=m)
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["compared"]) == set(m.config(cell)["correct"]["limits"])
    assert unchanged(tmp_path, before)


def test_source_and_why_lengths():
    for c in MANIFEST["configs"]:
        assert re.match(r"^https?://", c["source"]) and len(c["source"]) <= 200
    for x in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
