"""The PyTorch port's host side: it imports without JAX, and its
port-owned NumPy copies of the reference's host helpers are equal to
the originals (``array_equal``: the copies are verbatim, so any
difference is a fault, not rounding)."""

import ast
import subprocess
import sys
import textwrap
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from hyperres.core.crs import CRS  # noqa: E402
from hyperres.core.grid import Grid  # noqa: E402
from hyperres.kernels import glt as jglt  # noqa: E402
from hyperres.kernels import srf as jsrf  # noqa: E402
from hyperres.kernels import warp as jwarp  # noqa: E402
from hyperres.spectral import srf_tables as jtables  # noqa: E402
from hyperres_torch.core.crs import CRS as TCRS  # noqa: E402
from hyperres_torch.core.grid import Grid as TGrid  # noqa: E402
from hyperres_torch.kernels import host  # noqa: E402
from hyperres_torch.spectral import srf_tables as ttables  # noqa: E402
from hyperres_torch.testing import bench_scene  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    return bench_scene.generate_scene(0.05, 0)


def test_port_imports_without_jax():
    """Every module of hyperres_torch (found by walking the package),
    chip_smoke, bench_torch.py and every scripts/torch_*.py import in a
    process where importing jax, jaxlib, or hyperres or any hyperres.*
    module raises; none of them imports ``requests`` at import time
    (the catalog's default fetchers import it when called)."""
    code = textwrap.dedent("""
        import importlib, importlib.util, pathlib, pkgutil, sys
        class _NoJax:
            def find_spec(self, name, path=None, target=None):
                if (name.split(".")[0] in ("jax", "jaxlib")
                        or name == "hyperres"
                        or name.startswith("hyperres.")):
                    raise ModuleNotFoundError(f"blocked: {name}")
                return None
        sys.meta_path.insert(0, _NoJax())
        import hyperres_torch
        mods = ["hyperres_torch"] + [
            m.name for m in pkgutil.walk_packages(hyperres_torch.__path__,
                                                  "hyperres_torch.")]
        for m in ("hyperres_torch.core.config", "hyperres_torch.io.ingest",
                  "hyperres_torch.ortho.pipeline",
                  "hyperres_torch.testing.scenes",
                  "hyperres_torch.kernels.quantize",
                  "hyperres_torch.pipeline", "hyperres_torch.verify",
                  "hyperres_torch.fusion.histogram",
                  "hyperres_torch.fusion.linear",
                  "hyperres_torch.io.xlsx",
                  "hyperres_torch.spectral.srf_cache",
                  "hyperres_torch.spectral.synth",
                  "hyperres_torch.coreg.granule",
                  "hyperres_torch.kernels.phasecorr",
                  "hyperres_torch.tiling.tiles",
                  "hyperres_torch.artifacts.metadata",
                  "hyperres_torch.catalog.s2_stack",
                  "hyperres_torch.parallel.mesh",
                  "hyperres_torch.parallel.ops", "hyperres_torch.batch",
                  "hyperres_torch.cli", "hyperres_torch.__main__",
                  "hyperres_torch.viz.quicklook",
                  "hyperres_torch.viz.interactive",
                  "hyperres_torch.catalog.geometry",
                  "hyperres_torch.catalog.clients",
                  "hyperres_torch.catalog.cloud",
                  "hyperres_torch.catalog.pairing",
                  "hyperres_torch.ortho.toolkit",
                  "hyperres_torch.utils",
                  "hyperres_torch.utils.profiling"):
            assert m in mods, m
        for m in mods + ["chip_smoke", "bench_torch"]:
            importlib.import_module(m)
        scripts = sorted(pathlib.Path("scripts").glob("torch_*.py"))
        names = {p.name for p in scripts}
        for name in ("torch_bench_sr_granule.py",
                     "torch_bench_throughput.py",
                     "torch_validate_fullscale.py",
                     "torch_validate_fused_parity.py",
                     "torch_run_production_fullscale.py"):
            assert name in names, name
        for path in scripts:
            spec = importlib.util.spec_from_file_location(path.stem, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "hyperres", "requests")]
        assert not bad, bad
        print(len(mods), len(scripts), "ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith(" ok")


def _imported_modules(path):
    """Every module name the file at ``path`` imports, at any depth
    (function bodies included): each ``import`` and ``from ... import``
    statement (relative imports as written, dots included), and each
    call of ``import_module`` (``importlib.import_module`` or the bare
    name) or ``__import__`` whose first argument is a string constant."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Call) and node.args:
            f = node.func
            called = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            arg = node.args[0]
            if (called in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                names.append(arg.value)
    return names


def _jax_side_imports(path):
    """The names of ``_imported_modules(path)`` that reach JAX or the JAX
    package: ``jax``, ``jaxlib`` or their submodules, ``hyperres`` or
    ``hyperres.*`` (``hyperres_torch``, the port, is none of them)."""
    return [m for m in _imported_modules(path)
            if m.split(".")[0] in ("jax", "jaxlib", "hyperres")]


def test_card_suite_and_torch_demos_import_no_jax():
    """No file under tests_gpu/ (the card-side tests, run where there is
    no JAX) and no examples/torch_demo_*.py imports ``jax``, ``jaxlib``
    or ``hyperres`` (``hyperres_torch`` is the port): every import
    statement, at any depth, parsed with ``ast``."""
    files = (sorted((REPO / "tests_gpu").rglob("*.py"))
             + sorted((REPO / "examples").glob("torch_demo_*.py")))
    assert len(files) >= 4 + 2
    for path in files:
        bad = _jax_side_imports(path)
        assert not bad, (path, bad)


@pytest.mark.parametrize("pattern", ["hyperres_torch/**/*.py",
                                     "chip_smoke.py", "bench_torch.py",
                                     "scripts/torch_*.py",
                                     "examples/torch_*.py",
                                     "tests_gpu/**/*.py"])
def test_port_sources_import_no_jax(pattern):
    """The no-JAX rule on source, which ``test_port_imports_without_jax``
    cannot see where an import sits in a function body: no port file
    matching ``pattern`` imports ``jax``, ``jaxlib``, ``hyperres`` or
    ``hyperres.*`` in any statement at any depth, nor names one as a
    string in an ``import_module`` / ``__import__`` call (parsed with
    ``ast``; ``_imported_modules``)."""
    files = sorted(REPO.glob(pattern))
    assert files, pattern
    bad = {str(p.relative_to(REPO)): _jax_side_imports(p) for p in files}
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, f"port files importing JAX or the JAX package: {bad}"


def test_prepare_glt_copy(rng):
    glt = rng.integers(0, 40, size=(23, 31, 2)).astype(np.int32)
    glt[3, 4] = (99, 5)     # out of bounds in x
    glt[5, 6] = (4, 0)      # nodata in y
    for a, b in zip(host.prepare_glt(glt, (35, 37)),
                    jglt.prepare_glt(glt, (35, 37))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_index_fields_and_cstar_copy(scene):
    a = host.source_index_field(scene["ortho_grid"], scene["utm60"])
    b = jwarp.source_index_field(scene["ortho_grid"], scene["utm60"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        host.scanline_cstar(a[0], a[1], scene["ortho_grid"].height),
        jwarp.scanline_cstar(b[0], b[1], scene["ortho_grid"].height))
    for src, dst in ((scene["s2_grid"], scene["utm60"]),
                     (scene["utm60"], scene["s2_grid"]),
                     (scene["ortho_grid"], scene["utm60"])):
        ta = host.separable_index_axes(src, dst)
        tb = jwarp.separable_index_axes(src, dst)
        assert (ta is None) == (tb is None)
        if ta is not None:
            for x, y in zip(ta, tb):
                np.testing.assert_array_equal(x, y)


def test_scanline_cstar_rejects_non_monotone():
    rows = np.array([[0.0], [2.0], [1.0]], np.float32)
    cols = np.zeros_like(rows)
    with pytest.raises(ValueError, match="not monotone"):
        host.scanline_cstar(rows, cols, 4)


@pytest.mark.parametrize("method,scale", [("average", 6.0),
                                          ("average", None),
                                          ("bilinear", None),
                                          ("cubic", None)])
def test_separable_specs_and_matrices_copy(scene, method, scale):
    """Fast specs (on the scene's real transfers and on axes that have
    none) and dense weight matrices equal the reference's."""
    s2, utm = scene["s2_grid"], scene["utm60"]
    xs, ys = (utm if method == "average" else s2).pixel_center_coords()
    src = s2 if method == "average" else utm
    rows = np.asarray(src.colrow_of(src.x0, ys)[1], np.float64)
    cols = np.asarray(src.colrow_of(xs, src.y0)[0], np.float64)
    for idx, size in ((rows, src.height), (cols, src.width),
                      (rows * 1.013 + 0.2, src.height)):
        if method != "cubic":
            assert (host.separable_fast_spec(idx, size, method, scale=scale)
                    == jwarp.separable_fast_spec(idx, size, method,
                                                 scale=scale))
        np.testing.assert_array_equal(
            host.separable_weight_matrix(idx.astype(np.float32), size,
                                         method, scale=scale),
            jwarp.separable_weight_matrix(idx.astype(np.float32), size,
                                          method, scale=scale))


def test_cubic_weight_and_trapezoid_copy():
    x = np.linspace(-2.5, 2.5, 1001)
    np.testing.assert_array_equal(host.cubic_kernel_weight(x, xp=np),
                                  jwarp.cubic_kernel_weight(x, xp=np))
    wl = np.sort(np.random.default_rng(3).uniform(380, 2500, 57))
    np.testing.assert_array_equal(host.trapezoid_weights(wl),
                                  jsrf.trapezoid_weights(wl))


@pytest.mark.parametrize("platform", ["S2A", "S2B"])
def test_builtin_srf_and_weight_matrix_copy(platform):
    a = ttables.builtin_srf(platform)
    b = jtables.builtin_srf(platform)
    assert list(a) == list(b)
    for band in a:
        for x, y in zip(a[band], b[band]):
            np.testing.assert_array_equal(x, y)
    wl, good = bench_scene.emit_wavelength_grid(285)
    for mask in (None, good):
        wa = host.build_srf_weight_matrix(wl, a, mask)
        wb = jsrf.build_srf_weight_matrix(wl, b, mask)
        np.testing.assert_array_equal(wa[0], wb[0])
        assert wa[1] == wb[1]
        np.testing.assert_array_equal(wa[2], wb[2])


def test_bench_scene_copy(scene):
    """The jax-free scene generator equals bench._generate_scene."""
    ref = bench._generate_scene(0.05, 0)
    for k in ("raw", "s2_dn", "glt", "wavelengths", "good_mask",
              "spectra"):
        np.testing.assert_array_equal(scene[k], ref[k])
        assert scene[k].dtype == ref[k].dtype
    for k in ("ortho_grid", "utm60", "s2_grid"):
        # the port's Grid and the reference's: equal fields
        assert astuple(scene[k]) == astuple(ref[k])


def test_scene_cache_roundtrip(tmp_path):
    fresh = bench_scene.load_or_generate_scene(0.03, 1, cache_dir=tmp_path)
    assert len(list(tmp_path.glob("*.pkl"))) == 1
    cached = bench_scene.load_or_generate_scene(0.03, 1, cache_dir=tmp_path)
    for k in ("raw", "s2_dn", "glt"):
        np.testing.assert_array_equal(fresh[k], cached[k])
    assert cached["utm60"] == fresh["utm60"]


def test_scene_helpers_copy():
    from hyperres.testing import scenes

    wl, good = bench_scene.emit_wavelength_grid(97)
    wl2, good2 = scenes.emit_wavelength_grid(97)
    np.testing.assert_array_equal(wl, wl2)
    np.testing.assert_array_equal(good, good2)
    np.testing.assert_array_equal(bench_scene.endmember_spectra(wl),
                                  scenes.endmember_spectra(wl))
    x, y = np.meshgrid(np.linspace(4e5, 4.1e5, 13), np.linspace(5e6, 5.1e6, 7))
    np.testing.assert_array_equal(bench_scene.abundance_maps(x, y, seed=2),
                                  scenes.abundance_maps(x, y, seed=2))


def test_source_index_field_cross_crs_copy():
    """A geographic -> UTM transfer (the reprojection branch), each
    package on its own Grid and CRS classes."""
    def grids(crs_cls, grid_cls):
        geo = grid_cls(crs_cls.geographic(), 14.0, 52.1, 0.001, 0.001, 40,
                       30)
        dst = grid_cls(crs_cls.utm(33, True), 430000.0, 5770000.0, 60.0,
                       60.0, 25, 20)
        return geo, dst

    for x, y in zip(host.source_index_field(*grids(TCRS, TGrid)),
                    jwarp.source_index_field(*grids(CRS, Grid))):
        np.testing.assert_array_equal(x, y)
