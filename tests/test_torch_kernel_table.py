"""The kernel table (``chip_smoke.py``'s ``ROWS``) against the port's
kernel wrappers, on the CPU: a kernel without its table row fails here."""

import ast
import importlib
import pkgutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _launch_counters():
    """Every name a kernel wrapper passes to ``device.count_launch``: in
    each ``hyperres_torch`` module whose source calls ``count_launch``,
    the module-level ``*_NAME`` strings and the values of the ``*_NAMES``
    dicts (``KERNEL_NAME``, ``ROUTE_NAMES``, the pass names)."""
    import hyperres_torch

    names, modules = [], []
    for info in pkgutil.walk_packages(hyperres_torch.__path__,
                                      "hyperres_torch."):
        mod = importlib.import_module(info.name)
        tree = ast.parse(Path(mod.__file__).read_text())
        if not any(isinstance(n, ast.Call) and "count_launch" in (
                getattr(n.func, "id", None), getattr(n.func, "attr", None))
                for n in ast.walk(tree)):
            continue
        modules.append(info.name)
        for key, value in vars(mod).items():
            if key.endswith("_NAME") and isinstance(value, str):
                names.append(value)
            elif key.endswith("_NAMES") and isinstance(value, dict):
                names += list(value.values())
    return set(names), modules


def test_every_launch_counter_has_one_table_row():
    """Each launch counter of a kernel wrapper is named by exactly one
    ``ROWS`` entry (as its ``name``, or among its ``routes``), and no
    entry names a counter that no wrapper launches."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    counters, modules = _launch_counters()
    assert len(modules) >= 7 and len(counters) >= 14, (modules, counters)
    named = [n for row in chip_smoke.ROWS for n in (row.name, *row.routes)]
    assert sorted(named) == sorted(set(named)), named
    assert set(named) == counters, (set(named) ^ counters)
