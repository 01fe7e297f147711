"""The port's import surface and ``utils``: every name the JAX package's
subpackages export (their ``__all__``) is exported by the port's
counterpart, the top-level subpackages resolve lazily as in
``hyperres/__init__.py``, and ``utils.StageTimer`` / ``profile_trace``
behave as the reference's (``profile_trace`` on torch.profiler).

Tolerance: exact (names, module paths, ledger keys)."""

import importlib
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import hyperres  # noqa: E402
import hyperres_torch  # noqa: E402
from hyperres.utils import profiling as jprofiling  # noqa: E402
from hyperres_torch.utils import StageTimer, profile_trace  # noqa: E402

SUBPACKAGES = ("fusion", "core", "catalog", "ortho", "spectral", "artifacts",
               "coreg", "tiling", "parallel", "viz", "utils")
#: names of the JAX package that are TPU / XLA only (ROADMAP.md, Queue 1
#: item 10)
NOT_PORTED = {"utils": {"enable_compilation_cache"}}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_reference_names(sub):
    """Each name in ``hyperres.<sub>.__all__`` (less the XLA-only ones)
    is in the port's ``__all__`` and is an attribute there; every class
    and function among them is the port's own (its ``__module__`` under
    ``hyperres_torch``)."""
    j = importlib.import_module(f"hyperres.{sub}")
    t = importlib.import_module(f"hyperres_torch.{sub}")
    names = [n for n in j.__all__ if n not in NOT_PORTED.get(sub, ())]
    assert names
    missing = [n for n in names if not hasattr(t, n)]
    assert not missing, missing
    assert set(names) <= set(t.__all__)
    for n in names:
        obj = getattr(t, n)
        mod = getattr(obj, "__module__", None)
        if isinstance(obj, type) or callable(obj):
            assert mod and mod.startswith("hyperres_torch."), (n, mod)
        elif hasattr(obj, "__name__") and isinstance(obj, type(sys)):
            assert obj.__name__.startswith("hyperres_torch."), n


def test_not_ported_names_are_absent():
    """The XLA-only names are not exported (ROADMAP.md item 10)."""
    for sub, names in NOT_PORTED.items():
        t = importlib.import_module(f"hyperres_torch.{sub}")
        for n in names:
            assert not hasattr(t, n) and n not in t.__all__


def test_lazy_subpackage_list_is_the_references():
    """The port resolves the reference's lazy subpackages, less
    ``native`` (the g++ codec, not ported), and exports them in
    ``__all__`` beside ``core``."""
    assert hyperres_torch._SUBMODULES == tuple(
        m for m in hyperres._SUBMODULES if m != "native")
    assert hyperres_torch.__all__ == ["core", "__version__",
                                      *hyperres_torch._SUBMODULES]


@pytest.mark.parametrize("name", [m for m in hyperres._SUBMODULES
                                  if m != "native"])
def test_subpackage_resolves_by_attribute(name):
    """``hyperres_torch.<name>`` is the port's module of that name."""
    mod = getattr(hyperres_torch, name)
    assert mod.__name__ == f"hyperres_torch.{name}"


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no attribute 'native'"):
        hyperres_torch.native  # noqa: B018


def test_bare_import_is_lazy():
    """In a fresh process, ``import hyperres_torch`` imports ``core`` and
    ``device`` only; an attribute access imports its subpackage."""
    code = textwrap.dedent("""
        import sys
        import hyperres_torch
        loaded = sorted(m for m in sys.modules
                        if m.startswith("hyperres_torch."))
        assert all(m.startswith(("hyperres_torch.core",
                                 "hyperres_torch.device")) for m in loaded), \\
            loaded
        assert "hyperres_torch.pipeline" not in sys.modules
        hyperres_torch.pipeline
        assert "hyperres_torch.pipeline" in sys.modules
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# ---------------------------------------------------------------- utils ---

def test_stage_timer_is_the_ports_own():
    assert StageTimer.__module__ == "hyperres_torch.utils.profiling"
    assert StageTimer is not jprofiling.StageTimer


def test_stage_timer_ledger_equals_the_references():
    """A ledger of two stages (one with extras, one that raises) has the
    reference's keys and records; the seconds are the stage's; a ledger
    passed in is the one filled."""
    ledgers = []
    for cls in (StageTimer, jprofiling.StageTimer):
        t = cls()
        with t.stage("read", bands=32):
            time.sleep(0.01)
        with pytest.raises(KeyError):
            with t.stage("fail"):
                raise KeyError("x")
        ledgers.append(t.ledger)
    got, want = ledgers
    assert list(got) == list(want) == ["read", "fail"]
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()}
    assert got["read"]["bands"] == 32 and got["read"]["seconds"] >= 0.01
    shared = {}
    with StageTimer(shared).stage("x"):
        pass
    assert list(shared) == ["x"]


def test_profile_trace_is_a_no_op_without_a_directory(monkeypatch, tmp_path):
    """No directory and no ``HYPERRES_PROFILE_DIR``: nothing is traced
    or written, and the body runs."""
    monkeypatch.delenv("HYPERRES_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    ran = []
    with profile_trace():
        ran.append(torch.ones(4).sum().item())
    assert ran == [4.0]
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("how", ["argument", "env"])
def test_profile_trace_writes_a_chrome_trace(monkeypatch, tmp_path, how):
    """With a directory (argument or ``HYPERRES_PROFILE_DIR``) on the
    CPU, the body's ops are recorded and a Chrome trace that names them
    is written into the directory."""
    d = tmp_path / "prof"
    if how == "env":
        monkeypatch.setenv("HYPERRES_PROFILE_DIR", str(d))
        ctx = profile_trace()
    else:
        monkeypatch.delenv("HYPERRES_PROFILE_DIR", raising=False)
        ctx = profile_trace(str(d))
    with ctx:
        a = torch.ones(64, 64)
        (a @ a).sum()
    files = list(d.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


# ------------------------------------------------------ fusion exports ---

def test_ridge_params_record():
    """``fusion.RidgeSRParams`` is the port's own record; setting
    ``model.params`` from the JAX model's ``params`` gives buffers equal
    to its arrays (exact); reading it returns the buffers; it is None
    until fitted."""
    import numpy as np
    from hyperres.fusion import RidgeSpectralSR as JRidge
    from hyperres.fusion import RidgeSRParams as JParams
    from hyperres_torch.fusion import RidgeSpectralSR, RidgeSRParams

    assert RidgeSRParams.__module__ == "hyperres_torch.fusion.ridge_sr"
    assert RidgeSRParams is not JParams
    rng = np.random.default_rng(4)
    X = rng.random((500, 3)).astype(np.float32)
    Y = (0.1 + 0.8 * rng.random((500, 4))).astype(np.float32)
    jm = JRidge(3, 4).fit(X, Y)
    tm = RidgeSpectralSR(3, 4, device="cpu")
    assert tm.params is None
    tm.params = jm.params
    for name in ("x_mean", "x_std", "W", "intercept"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm.params, name)))
    p = tm.params
    assert isinstance(p, RidgeSRParams) and p.W is tm.W
    other = RidgeSpectralSR(3, 4, device="cpu")
    other.params = p
    assert torch.equal(other(torch.from_numpy(X)), tm(torch.from_numpy(X)))
