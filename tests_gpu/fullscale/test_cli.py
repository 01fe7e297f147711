"""``python -m hyperres_torch`` in subprocesses on the card: ``scene``
(CLI_SCENE, ``make_scene``'s demo size), then ``ortho``, ``fuse``,
``batch``, ``verify-granule``, ``info`` and ``quicklook`` in parallel."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.gpu

CLI_SCENE = ("--raw", "96", "112", "--bands", "64", "--s2-size", "420")
CLI_TIMEOUT = 300
REPO = Path(__file__).resolve().parents[2]


def start(*argv):
    return subprocess.Popen(
        [sys.executable, "-m", "hyperres_torch", *argv], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish(proc):
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out, err


def test_cli_subcommands(card, workdir):
    """Each exits 0 within CLI_TIMEOUT s (or ``verify-granule`` 1 with
    ``passed`` false); ``scene`` to ``verify-granule`` print JSON that
    parses, ``info`` names the raster, ``quicklook`` prints the viewer it
    wrote."""
    rc, out, err = finish(start("scene", str(workdir / "scene"), *CLI_SCENE))
    assert rc == 0, err[-2000:]
    doc = json.loads(out)
    nc, s2 = doc["emit_nc"], doc["s2_tif"]
    jobs = workdir / "jobs.json"
    jobs.write_text(json.dumps([{"pair_id": "p1", "emit_nc_path": nc,
                                 "s2_stack_tif": s2}]))
    procs = {
        "ortho": start("ortho", nc, str(workdir / "ortho"), "--s2", s2),
        "fuse": start("fuse", nc, s2, str(workdir / "fuse"), "--tile-size",
                      "16", "--max-tiles", "2"),
        "batch": start("batch", str(jobs), str(workdir / "batch")),
        "verify-granule": start("verify-granule", nc, s2,
                                str(workdir / "verify")),
        "info": start("info", s2),
        "quicklook": start("quicklook", nc, str(workdir / "q.html")),
    }
    results = {name: finish(proc) for name, proc in procs.items()}
    for name, (rc, out, err) in results.items():
        if name == "info":
            ok = rc == 0 and Path(s2).name in out
        elif name == "quicklook":
            ok = rc == 0 and Path(out.strip()).exists()
        else:
            doc = json.loads(out)
            ok = rc == 0 or (name == "verify-granule" and rc == 1
                             and doc["passed"] is False)
        assert ok, (name, rc, out[-500:], err[-2000:])
