"""``BENCHMARK.json`` and the files it names, found by name.

- a cell's configuration: ``benchmark/configs/<config>.json``;
- its traffic mix: ``benchmark/traffic/<traffic>.json``, data that the
  system adapter reads;
- the system adapter, which holds the request loop and its spans:
  ``benchmark/systems/<name>.py``, where ``name`` is the mix's
  ``"system"`` where it gives one (a mix whose loop is new code) and the
  configuration's ``"system"`` otherwise;
- a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, or,
  where there is no such file, that of the metric's name without its
  last dotted part (``device_idle_pct.sr10`` ->
  ``device_idle_pct.py``): one reader for a quantity split by cell.

A configuration, a mix (with its loop) or a metric is added by adding
its files and its entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
END_TO_END_SOURCES = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class ManifestError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the benchmark's
    rules."""


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def check_names(manifest: dict) -> None:
    """Names and units in the allowed characters, none used twice."""
    groups = [("configs", manifest["configs"]),
              ("workloads", manifest["workloads"]),
              ("metrics", manifest["end_to_end"] + manifest["per_layer"])]
    for group, items in groups:
        names = [x["name"] for x in items]
        if len(set(names)) != len(names):
            raise ManifestError(f"a name repeats in {group}: {names}")
        for x in items:
            for key in ("name", "config", "traffic"):
                if key in x and not NAME_RE.match(x[key]):
                    raise ManifestError(f"bad {key} {x[key]!r}")
            if "unit" in x and not UNIT_RE.match(x["unit"]):
                raise ManifestError(f"bad unit {x['unit']!r} of {x['name']}")
            for key in x.get("reduced", []):
                if not NAME_RE.match(key):
                    raise ManifestError(f"bad reduced key {key!r}")
    for m in manifest["end_to_end"]:
        if m["source"] not in END_TO_END_SOURCES:
            raise ManifestError(f"{m['name']}: source {m['source']!r}")
        if m["better"] not in ("lower", "higher"):
            raise ManifestError(f"{m['name']}: better {m['better']!r}")
    for m in manifest["per_layer"]:
        if m["source"] not in SOURCES or m["better"] not in ("lower", "higher"):
            raise ManifestError(f"{m['name']}: source or better")


class Manifest:
    """The parsed ``BENCHMARK.json`` of a checkout."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.path = Path(path)
        self.data = load_json(self.path)
        check_names(self.data)
        self.bench_dir = self.path.parent / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise ManifestError(f"no workload {name!r} in {self.path}")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise ManifestError(f"no config {name!r}")

    def config(self, cell: dict) -> dict:
        entry = self.config_entry(cell["config"])
        return load_json(self.path.parent / entry["file"])

    def traffic(self, cell: dict) -> dict:
        return load_json(self.bench_dir / "traffic" / f"{cell['traffic']}.json")

    def end_to_end(self, cell: dict) -> List[dict]:
        """The cell's end-to-end metrics: those without ``workloads`` and
        those that list the cell."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> List[dict]:
        """The cell's per-layer metrics: those that list it, and those
        without ``workloads`` whose moved metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.data["per_layer"]:
            if "workloads" in m:
                if cell["name"] in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out

    def system(self, config: dict, traffic: Optional[dict] = None
               ) -> ModuleType:
        """The adapter the mix names, else the configuration's."""
        name = (traffic or {}).get("system") or config["system"]
        return load_module(self.bench_dir / "systems" / f"{name}.py",
                           f"benchmark_system_{name}")

    def reader(self, metric: dict) -> ModuleType:
        name = metric["name"]
        path = self.bench_dir / "metrics" / f"{name}.py"
        if not path.is_file() and "." in name:
            path = path.with_name(name.rsplit(".", 1)[0] + ".py")
        return load_module(path, "benchmark_metric_" + name.replace(".", "_")
                           .replace("-", "_"))


def load_module(path: Path, mod_name: str) -> ModuleType:
    """Import the Python file ``path`` (its name may hold dots)."""
    if not path.is_file():
        raise ManifestError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
