"""The control of ``correct``: the plain reference one precision below the
configuration's, put in the program's place, fails at least one compared
number of the cell, where the program passes them all, at the cells' own
sizes on the card (about 2.5 minutes on an H100). Both come from
``benchmark/calibrate.py``, which drives the harness's own run and prints
the readings on many seeds."""

import pytest

from benchmark.calibrate import run_seed
from benchmark.harness.compare import checks
from benchmark.harness.manifest import Manifest

from conftest import small_manifest, with_kept_cells


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rgb10.resident", "rgb10.streamed",
                                  "sr10.resident"])
@pytest.mark.parametrize("seed", [2**33 + 11, 2**33 + 12, 2**33 + 13])
def test_control_fails_where_the_program_passes(cuda, cell, seed):
    m = with_kept_cells(Manifest())
    limits = m.config(m.cell(cell))["correct"]["limits"]
    line = run_seed(m, cell, seed, 0.5, cuda, control=True)
    assert line["correct"] is True, line["program"]
    control = checks(line["control"], limits)
    assert not all(x.ok for x in control), control


@pytest.mark.parametrize("cell", ["rgb10.resident", "sr10.resident"])
def test_calibration_reads_the_harness_run_and_the_control(cell):
    """On the CPU at a small size: the program's readings are those the
    run compared, and the control reads the same numbers."""
    import torch

    line = run_seed(small_manifest(), cell, 2**33 + 21, 0.05,
                    torch.device("cpu"), control=True)
    assert line["correct"] is True and line["requests"] >= 1
    assert set(line["control"]) == set(line["program"])
    assert all(v == v for v in line["control"].values())
