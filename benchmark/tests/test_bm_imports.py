"""Import rules: nothing in ``benchmark/`` imports JAX or the JAX
package, and the plain reference imports nothing of the program. Top-level
module names (before the first dot) are compared whole, so
``hyperres_torch`` is not ``hyperres``."""

import ast
from pathlib import Path

import pytest

from benchmark.harness.runner import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def imported_tops(path: Path):
    """Top-level names of every module the file imports, at any depth,
    and the string arguments of import_module / __import__ calls."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call):
            f = node.func
            name = getattr(f, "attr", getattr(f, "id", ""))
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".", 1)[0])
    return out


def py_files(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", py_files(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere_in_the_benchmark(path):
    assert not imported_tops(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", py_files(BENCH / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "hyperres_torch" not in tops and not tops & set(FORBIDDEN)
    # relative imports reach only the benchmark's own frozen copies
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert (node.module or "").split(".")[0] in ("harness", "reference",
                                                        "granule", "ridge",
                                                        "ingest"), node.module


def test_the_checker_compares_whole_top_level_names():
    mods = {"hyperres_torch": 1, "hyperres_torch.fusion": 1, "json": 1}
    assert forbidden_modules(mods) == []
    mods.update({"hyperres.core": 1, "jaxlib": 1, "flax.linen": 1})
    assert forbidden_modules(mods) == ["flax.linen", "hyperres.core", "jaxlib"]


def test_harness_run_loads_no_jax():
    """A CPU run of a small cell leaves no forbidden module behind in a
    fresh interpreter."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import run_small\n"
        "run_small('sr10.resident', seconds=0.05)\n"
        "from benchmark.harness.runner import forbidden_modules\n"
        "print('FOUND', forbidden_modules())\n"
    ) % (str(BENCH.parent), str(BENCH / "tests"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FOUND []" in r.stdout


@pytest.mark.parametrize("where", ["reader", "readings"])
def test_a_run_that_loads_the_jax_package_late_prints_no_result(tmp_path,
                                                                where):
    """A stub module named ``hyperres``, imported by a per-layer reader
    (traced run) or by the adapter's comparison (untraced run), both of
    which run after the window: the run exits 5 with no result line."""
    import subprocess
    import sys

    sys.path.insert(0, str(BENCH / "tests"))
    from conftest import dummy_checkout

    stub = tmp_path / "stub" / "hyperres"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    hook = f"import sys; sys.path.insert(0, {str(stub.parent)!r}); import hyperres"
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    path, _ = dummy_checkout(checkout, **{f"{where}_hook": hook})
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from benchmark.harness.manifest import Manifest\n"
            "from benchmark.harness.runner import run_cell, print_result\n"
            "print_result(run_cell(Manifest(%r), 'dummy.cell', 1, 0.05, %r,"
            " torch.device('cpu'), time.perf_counter))\n"
            ) % (str(checkout), str(path), where == "reader")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=checkout)
    assert r.returncode == 5, r.stderr[-2000:]
    assert "FATAL" in r.stderr and "hyperres" in r.stderr
    assert r.stdout.strip() == ""
