"""The frozen copies and the plain reference held to the program at small
sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.harness.scene import granule_scene, swath_geometry
from benchmark.harness.spectra import (emit_wavelength_grid, s2a_srf,
                                       srf_weight_matrix)
from benchmark.reference import granule as ref
from benchmark.reference.ingest import roundtrip

from conftest import SMALL_RAW, run_small

CPU = torch.device("cpu")


def test_geometry_is_the_bench_scene_s():
    from hyperres_torch.testing.bench_scene import swath_geometry as prog

    got, want = swath_geometry(60, 70), prog(60, 70)
    np.testing.assert_array_equal(got["glt"], want["glt"])
    for k in ("ortho_grid", "s2_grid", "utm60"):
        g, w = got[k], want[k]
        assert (g.x0, g.y0, g.dx, g.dy, g.width, g.height) == \
            (w.x0, w.y0, w.dx, w.dy, w.width, w.height)


def test_srf_weights_are_the_program_s():
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.spectral.srf_tables import builtin_srf

    wl, good = emit_wavelength_grid()
    want, _, _ = build_srf_weight_matrix(
        wl, builtin_srf("S2A", bands=["B2", "B3", "B4"]), good)
    np.testing.assert_array_equal(srf_weight_matrix(wl, s2a_srf(), good), want)


def test_warp_fields_are_the_plan_s():
    from hyperres_torch.kernels.host import (prepare_glt, scanline_cstar,
                                             source_index_field)
    from benchmark.systems.fused_ortho_plan import _grid

    sc = swath_geometry(48, 56)
    f = ref.warp_fields(sc["glt"], (48, 56), sc["ortho_grid"], sc["utm60"])
    flat, valid = prepare_glt(sc["glt"], (48, 56))
    np.testing.assert_array_equal(f["flat"], flat)
    np.testing.assert_array_equal(f["valid"], valid)
    rows, cols = source_index_field(_grid(sc["ortho_grid"]), _grid(sc["utm60"]))
    np.testing.assert_array_equal(f["rows"], rows)
    np.testing.assert_array_equal(f["cols"], cols)
    np.testing.assert_array_equal(
        f["cstar"], scanline_cstar(rows, cols, sc["ortho_grid"].height))


def test_ingest_reference_is_the_default_ingest():
    from hyperres_torch.io.ingest import stream_cube_to_device

    raw = granule_scene(24, 28, 285, 3, CPU)["raw"].numpy()
    raw[0, 0, 5] = -9999.0
    got = stream_cube_to_device(lambda a, b: raw[..., a:b], raw.shape,
                                chunk_bands=32, depth=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), roundtrip(raw, "u16", CPU).numpy())


def test_scene_is_made_from_the_seed():
    a = granule_scene(24, 28, 285, 5, CPU)
    b = granule_scene(24, 28, 285, 5, CPU)
    c = granule_scene(24, 28, 285, 6, CPU)
    assert torch.equal(a["raw"], b["raw"]) and torch.equal(a["s2_dn"], b["s2_dn"])
    assert not torch.equal(a["raw"], c["raw"])
    # the world is the same in every run: only the noise differs
    assert torch.equal(a["s2_dn"], c["s2_dn"])
    assert a["s2_dn"].dtype == torch.uint16 and int(a["s2_dn"].to(torch.int32).max()) < 65535


@pytest.mark.parametrize("cell", ["rgb10.resident", "rgb10.streamed",
                                  "sr10.resident"])
def test_reference_holds_the_program_at_small_sizes(cell):
    res = run_small(cell, seconds=0.1)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
