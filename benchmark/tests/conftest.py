"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q``).
The cases marked ``gpu`` need a CUDA device and skip without one; the
card's machine runs them with the same command."""

import copy
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: raw sizes of the small granule the CPU tests run (full: 1242 x 1280):
#: its UTM grid holds more pixels than the OT draws, so the draw matters
SMALL_RAW = [90, 96, 285]
SMALL_FOOTPRINT = [64, 80]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: the cell whose mix, adapter branch, reference and readers the
#: benchmark keeps for a later PR (PERF.md, Open questions): the host's
#: clock spreads its time per granule past the largest bound, so
#: ``BENCHMARK.json`` does not list it; the tests run it as it would be
#: listed
KEPT_CELLS = {
    "workloads": [
        {"name": "rgb10.streamed", "config": "emit_granule_rgb10",
         "traffic": "granule_streamed", "chips": 1,
         "why": "each granule's raw cube from host memory through the "
                "default u16 ingest, the plan, fused_10m back to host"}],
    "end_to_end": [
        {"name": "granule_streamed_s", "unit": "s", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["rgb10.streamed"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "granule_streamed_s",
         "workloads": ["rgb10.streamed"]}
        for name, unit, source, layer in (
            ("ingest_s", "s", "host_clock",
             "Ingest (io/ingest.py stream_cube_to_device)"),
            ("readback_s", "s", "host_clock",
             "Products to host (fused_10m .cpu())"),
            ("device_idle_pct.streamed", "%", "device_trace",
             "Device (one H100)"))],
}


def with_kept_cells(m):
    """``m`` with the entries of :data:`KEPT_CELLS` added, unless it
    lists those cells already."""
    names = {w["name"] for w in m.data["workloads"]}
    if not names & {w["name"] for w in KEPT_CELLS["workloads"]}:
        for key, entries in KEPT_CELLS.items():
            m.data[key] += copy.deepcopy(entries)
    return m


def small_manifest(path=None, traced_requests=2):
    """The manifest with :data:`KEPT_CELLS`, every configuration cut to a
    CPU test's size (the limits of ``correct`` kept) and short trace
    slices."""
    from benchmark.harness.manifest import Manifest

    m = with_kept_cells(Manifest(path or ROOT / "BENCHMARK.json"))
    config, traffic = m.config, m.traffic

    def small_config(cell):
        cfg = copy.deepcopy(config(cell))
        if "raw_hwb" in cfg.get("sizes", {}):
            cfg["sizes"] = {"raw_hwb": SMALL_RAW}
        elif "footprint_hw" in cfg.get("sizes", {}):
            cfg["sizes"]["footprint_hw"] = SMALL_FOOTPRINT
        return cfg

    def small_traffic(cell):
        t = copy.deepcopy(traffic(cell))
        t["trace"] = {"first": 1, "requests": traced_requests}
        t["sample_within"] = 2
        if "n_train" in t:
            t["n_train"] = 4000
        return t

    m.config, m.traffic = small_config, small_traffic
    return m


def run_small(cell, seed=2**33 + 5, seconds=0.2, trace=False, m=None,
              system_factory=None):
    import torch

    from benchmark.harness.runner import run_cell

    t0 = time.perf_counter()
    return run_cell(m or small_manifest(), cell, seed, seconds, trace,
                    torch.device("cpu"), lambda: time.perf_counter() - t0,
                    system_factory=system_factory)


DUMMY_SYSTEM = '''
import time


class System:
    span_names = ("answer",)

    def __init__(self, config, traffic, seed, device, log, spans):
        self.spans, self.seed, self.n = spans, seed, 0
        self.names = list(config["correct"]["limits"])

    def setup(self):
        pass

    def request(self, i):
        with self.spans.span("answer", i):
            time.sleep(0.001)
            self.n += 1

    def work_per_request(self):
        return 1.0

    def shapes(self):
        return {}

    def release(self):
        pass

    def readings(self):
        READINGS_HOOK
        return {k: 0.0 for k in self.names}
'''

DUMMY_METRIC = '''
def read(ctx):
    READER_HOOK
    return 1e3 * ctx.spans.mean_seconds("answer")
'''


def dummy_checkout(tmp_path, config=None, loop=None, reader_hook="pass",
                   readings_hook="pass"):
    """A copy of the benchmark at ``tmp_path`` with one more cell,
    ``dummy.cell``, added by new files and manifest entries alone: a
    mix ``dummy_mix`` and a metric ``dummy.answer_ms`` moving a new
    end-to-end metric ``dummy_rate_s``; with ``config`` None a new
    configuration ``dummy_cfg`` and its adapter ``dummy_sys``, else that
    configuration with the mix naming its own adapter ``loop``. The hooks
    are code run in the reader and in the adapter's ``readings``.
    Returns the manifest's path and the copied files' bytes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = {"end_to_end": {"dummy_rate_s": "time_per_request"},
           "trace": {"first": 0, "requests": 1}}
    if config is None:
        config, system = "dummy_cfg", "dummy_sys"
        (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(
            {"system": system, "reduced": [], "assumed": [],
             "correct": {"limits": {"answer_gap": 0.0}}}))
        data["configs"].append({"name": config, "source": "https://example.org",
                                "file": "benchmark/configs/dummy_cfg.json",
                                "reduced": [], "why": "a test"})
    else:
        system = mix["system"] = loop
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "systems" / f"{system}.py").write_text(
        DUMMY_SYSTEM.replace("READINGS_HOOK", readings_hook))
    (bench / "metrics" / "dummy.answer_ms.py").write_text(
        DUMMY_METRIC.replace("READER_HOOK", reader_hook))
    data["workloads"].append({"name": "dummy.cell", "config": config,
                              "traffic": "dummy_mix", "chips": 1, "why": "test"})
    data["end_to_end"].insert(0, {"name": "dummy_rate_s", "unit": "s",
                                  "better": "lower", "bound": 0.05,
                                  "source": "host_clock",
                                  "workloads": ["dummy.cell"]})
    data["per_layer"].append({"name": "dummy.answer_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "Answers", "moves": "dummy_rate_s",
                              "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return tmp_path / "BENCHMARK.json", before


def unchanged(tmp_path, before) -> bool:
    """Every file the copy had before its additions is byte for byte
    the same."""
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    return all(after.get(k) == v for k, v in before.items())
