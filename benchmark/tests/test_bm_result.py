"""The result's last line: its keys, the metrics each run reports, and
the compared numbers last."""

import json
import subprocess
import sys

from benchmark.harness.manifest import Manifest

from conftest import ROOT, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line_has_the_cell_s_end_to_end_metrics():
    res = run_small("rgb10.resident", seconds=0.1)
    assert list(res)[:5] == KEYS and list(res)[-1] == "compared"
    json.dumps(res)
    m = Manifest()
    want = {x["name"]: x["unit"] for x in m.end_to_end(m.cell("rgb10.resident"))}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"}


def test_traced_line_has_only_per_layer_metrics_and_the_trace():
    res = run_small("sr10.resident", seconds=0.1, trace=True)
    m = Manifest()
    layer = {x["name"] for x in m.per_layer(m.cell("sr10.resident"))}
    assert set(res["metrics"]) <= layer
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    assert list(res)[-1] == "compared"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    r = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", "rgb10.resident", "--seed",
                        str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_run_refuses_an_unknown_cell():
    r = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", "no.such.cell", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails_without_a_result(tmp_path):
    """With only BENCHMARK.json and the benchmark's files (no program), a
    run exits nonzero and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from benchmark.harness.manifest import Manifest\n"
            "from benchmark.harness.runner import run_cell, print_result\n"
            "m = Manifest(%r)\n"
            "print_result(run_cell(m, 'sr10.resident', 1, 0.1, False,"
            " torch.device('cpu'), time.perf_counter))\n"
            ) % (str(tmp_path), str(tmp_path / "BENCHMARK.json"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0
    assert "hyperres_torch" in r.stderr
    assert r.stdout.strip() == ""
