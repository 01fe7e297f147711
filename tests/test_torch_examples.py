"""The torch demos of the pair pipeline (``examples/torch_demo_pairs.py``,
``examples/torch_demo_coreg.py``) against their JAX twins on the CPU: each
torch demo runs through ``runpy`` with ``--device cpu`` at its twin's
sizes, its ``main`` returns the numbers it prints, and the twin runs on
the same arguments with its printed numbers read back. Each test states
its bounds; every bound adds half a unit of the last digit the twin
prints."""

import re
import runpy
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def run_twin(name, argv, capsys):
    """Run ``examples/demo_<name>.py`` as a script; return what it
    printed."""
    old = sys.argv
    sys.argv = [str(EXAMPLES / f"demo_{name}.py")] + argv
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def run_torch(name, argv):
    """``main(argv)`` of ``examples/torch_demo_<name>.py``."""
    return runpy.run_path(str(EXAMPLES / f"torch_demo_{name}.py"))["main"](
        argv)


def printed(pattern, text):
    """The numbers of the first line of ``text`` that ``pattern``
    matches."""
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return m.groups()


def test_torch_demo_pairs_matches_jax(tmp_path, capsys):
    """The pairs demo: the ortho cube's PSNR and SAM against the analytic
    world within 0.05 dB and 5e-5 rad of the twin's (deterministic, no
    draw: the ortho cube agrees to 1e-5 in the interior,
    tests/test_torch_ortho.py, which moves a 53 dB PSNR by at most 0.04
    dB and the SAM by at most 3.3e-5 rad), the same tile count, and the
    SR fit's mean R² within 1e-4 (tests/test_torch_pair_pipeline.py's
    bound: the SR training set does not depend on the OT draw). The
    quicklooks are written."""
    jax_out = run_twin("pairs", [str(tmp_path / "jax")], capsys)
    got = run_torch("pairs", [str(tmp_path / "torch"), "--device", "cpu"])
    psnr, = printed(r"ortho PSNR vs world: ([-\d.]+) dB", jax_out)
    sam, = printed(r"ortho SAM vs world:\s+([-\d.]+) rad", jax_out)
    r2, = printed(r"spectral-SR mean R2: ([-\d.]+)", jax_out)
    tiles, = printed(r"tiles: (\d+);", jax_out)
    assert abs(got["ortho_psnr_db"] - float(psnr)) <= 0.05 + 0.005
    assert abs(got["ortho_sam_rad"] - float(sam)) <= 5e-5 + 5e-5
    assert got["n_tiles"] == int(tiles) == 8
    assert abs(got["sr_r2_mean"] - float(r2)) <= 1e-4 + 5e-5
    assert Path(got["report"]).is_file()
    for png in ("emit_utm_quicklook.png", "fusion_side_by_side.png"):
        assert (tmp_path / "torch" / png).is_file()


def test_torch_demo_coreg_matches_jax(tmp_path, capsys):
    """The coregistration demo: ``success`` and the S2 band equal to the
    twin's, the recovered shift within 0.05 px of the twin's in each axis
    (tests/test_torch_pair_pipeline.py's coregistration bound) and within
    0.15 px of the applied one (2.4, -1.7)."""
    jax_out = run_twin("coreg", [str(tmp_path / "jax")], capsys)
    got = run_torch("coreg", [str(tmp_path / "torch"), "--device", "cpu"])
    success, band = printed(r"success: (\w+)\s+band: (\w+)", jax_out)
    dy, dx = printed(r"recovered: dy=([-\d.]+) dx=([-\d.]+)", jax_out)
    assert str(got["success"]) == success == "True"
    assert got["s2_code"] == band
    for a, b, applied in zip(got["recovered_px"], (dy, dx),
                             got["applied_px"]):
        assert abs(a - float(b)) <= 0.05 + 5e-4
        assert abs(a - applied) <= 0.15
