"""``coregister_stack`` on the card with the resample kernel and with the
dense route it replaces there (``sep_resample.takes_kernel`` forced off),
on ``card_inputs.coreg_scene`` at the kernel table's settings and the
coregistration cell's EMIT nodata value."""

import numpy as np
import pytest

import card_inputs
from card_inputs import EMIT_NODATA, counted

pytestmark = pytest.mark.gpu


def test_coregister_stack_keeps_its_tie_points_on_the_kernel(card,
                                                             monkeypatch):
    """The same tie points, kept and used, with the same shifts and
    reliabilities, the same affine and the same u16 product: the
    resample's two routes are equal bit for bit at this transfer. The
    kernel route launches the resample kernel once; the dense route
    never."""
    from hyperres_torch.core.config import CoregConfig
    from hyperres_torch.coreg.granule import coregister_stack
    from hyperres_torch.kernels import sep_resample as sr

    emit, emit_grid, stack, s2_grid = card_inputs.coreg_scene(card)

    def run():
        return coregister_stack(
            {"B08": emit}, emit_grid, stack, s2_grid, CoregConfig(
                window_size=(128, 128), grid_res=150.0, min_reliability=25.0),
            s2_bandmap={"B03": 1, "B04": 2, "B08": 3},
            nodata_emit=EMIT_NODATA, nodata_s2=card_inputs.S2_NODATA,
            device=card)

    kernel, k_counts = counted(run)
    monkeypatch.setattr(sr, "takes_kernel", lambda device: False)
    dense, d_counts = counted(run)
    assert k_counts.get(sr.KERNEL_NAME) == 1
    assert sr.KERNEL_NAME not in d_counts
    assert kernel["final"]["success"] and dense["final"]["success"]
    tk, td = (out["result"].tie_points for out in (kernel, dense))
    assert len(tk) > 10 and tk == td
    np.testing.assert_array_equal(kernel["result"].affine,
                                  dense["result"].affine)
    assert bool((kernel["shifted"] == dense["shifted"]).all())
