"""The ortho export path at full width (``ortho``: the u16 run with LOC,
then the f32 run), the resident core against the f32 run with LOC, OBS
and the L2A mask, and the quantize and SRF kernels against their plain
versions on its UTM cube."""

import numpy as np
import pytest
import torch

from card_inputs import (
    ORTHO_BANDS, ORTHO_CHUNKS, REFL_HI_EFF, SRF_TOL, counted,
)
from hyperres_torch.core.constants import NO_DATA_VALUE
from hyperres_torch.kernels import srf
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES
from hyperres_torch.kernels.quantize import (
    KERNEL_NAME as QUANT, pallas_quantize_u16, quantize_u16,
    quantize_u16_reference,
)

pytestmark = pytest.mark.gpu

#: the u16 ingest against the f32 one on pixels whose taps are all valid:
#: each raw value moves by at most half a step (vmax_b - vmin_b) / 65534,
#: and the two-pass cubic's weights sum in absolute value to at most 1.25
#: per pass
CUBIC_ABS_GAIN = 1.5625
U16_INGEST_ATOL = 1e-6


@pytest.mark.parametrize("transfer", ["u16", "f32"])
def test_ortho_run(ortho, transfer):
    """Each run launches each fused ortho warp pass once per chunk (and
    once for LOC) and the quantize kernel once per u16 product (DATA, its
    diagnostic band, LOC); its UTM cube is a finite 285-band cube; the
    u16 run's decoded DATA GeoTIFF equals the plain quantizer's codes of
    its cube."""
    run = ortho[transfer]
    loc = int(transfer == "u16")
    assert all(run.counts.get(k) == ORTHO_CHUNKS + loc
               for k in KERNEL_NAMES.values()), run.counts
    assert run.counts.get(QUANT) == 2 + loc, run.counts
    cube = run.res.device_cube
    assert cube.shape[-1] == ORTHO_BANDS and bool(torch.isfinite(cube).all())
    if transfer == "u16":
        want = quantize_u16_reference(cube, 0.0, REFL_HI_EFF, None, 65535,
                                      nodata_src=NO_DATA_VALUE)
        assert np.array_equal(np.moveaxis(run.data, 0, -1),
                              want.cpu().numpy())


def test_f32_fold_and_u16_ingest(card, granule, ortho):
    """The f32 run's fold is bit-equal to one ``orthowarp_two_pass`` of
    the whole raw cube (read through the port's reader); the u16 run's
    cube lies within CUBIC_ABS_GAIN * step_b / 2 + U16_INGEST_ATOL of it
    where every tap is valid, with the same fill pixels."""
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.kernels.banded import scanline_resample
    from hyperres_torch.kernels.host import (
        prepare_glt, scanline_cstar, source_index_field,
    )
    from hyperres_torch.kernels.warp import orthowarp_two_pass

    cube16 = ortho["u16"].res.device_cube
    cube32 = ortho["f32"].res.device_cube
    with EmitGranule(granule.scene.emit_nc_path) as g:
        raw = torch.from_numpy(g.read_cube()).to(card)
        flat, valid = prepare_glt(g.glt, (g.raw_height, g.raw_width))
        rows, cols = source_index_field(g.ortho_grid,
                                        ortho["f32"].res.utm_grid)
        cstar = scanline_cstar(rows, cols, g.ortho_grid.height)
    flat, valid, rows, cols, cstar = (torch.from_numpy(a).to(card) for a in
                                      (flat, valid, rows, cols, cstar))
    assert torch.equal(orthowarp_two_pass(raw, flat, valid, rows, cols,
                                          cstar), cube32)
    # the validity plane's warp (the weight mass) is 1 where every tap is
    # valid
    vplane = valid.to(torch.float32)[..., None]
    mass = scanline_resample(scanline_resample(vplane, cstar, 1), rows,
                             0)[..., 0]
    full = ((mass - 1.0).abs() <= 1e-6) & (cube32[..., 0] != NO_DATA_VALUE)
    ok = torch.isfinite(raw) & (raw != NO_DATA_VALUE)
    vmin = torch.where(ok, raw, float("inf")).amin(dim=(0, 1)).double()
    vmax = torch.where(ok, raw, float("-inf")).amax(dim=(0, 1)).double()
    del raw, ok
    lim = (CUBIC_ABS_GAIN * (vmax - vmin) / 65534.0 / 2.0
           + U16_INGEST_ATOL).float()
    assert float(((cube16 - cube32).abs() / lim)[full].max()) <= 1.0
    assert torch.equal(cube16 == NO_DATA_VALUE, cube32 == NO_DATA_VALUE)


def test_resident_core_equals_the_file_path(card, granule):
    """With LOC, OBS and the L2A mask at full width: one
    ``orthorectify_cube`` call of the whole raw cube launches each
    fused ortho warp pass three times (DATA, LOC, OBS) and the quantize
    kernel four times (DATA, its diagnostic band, LOC, OBS), and its products
    equal ``orthorectify_granule``'s f32 run (the streamed fold in 9
    chunks) bit for bit: the ENVI cubes and the decoded GeoTIFF codes."""
    import card_inputs
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.ortho.pipeline import (
        OrthoGeometry, orthorectify_cube, quality_flags)

    run = card_inputs.ortho_products_run()
    mask = card_inputs.granule_products().mask_bands
    obs_file = card_inputs.granule_products().obs
    with EmitGranule(granule.scene.emit_nc_path) as g, \
            EmitGranule(obs_file) as og:
        geom = OrthoGeometry.build(g.glt, (g.raw_height, g.raw_width),
                                   g.ortho_grid, run.res.utm_grid, card)
        raw = torch.from_numpy(g.read_cube()).to(card)
        loc = torch.from_numpy(np.stack(
            [g.location("lon"), g.location("lat"), g.location("elev")],
            axis=-1).astype(np.float32)).to(card)
        obs = torch.from_numpy(og.read_cube()).to(card)
    qmask = quality_flags(torch.from_numpy(mask).to(card), (0, 1, 3))
    core, counts = counted(lambda: orthorectify_cube(
        geom, raw, loc=loc, obs=obs, quality_mask=qmask))
    assert all(counts.get(k) == 3 for k in KERNEL_NAMES.values()), counts
    assert counts.get(QUANT) == 4, counts
    assert run.res.info["mask"]["ortho_cells_quality_masked"] > 0
    assert torch.equal(core.data, run.res.device_cube)
    assert np.array_equal(core.loc.cpu().numpy(), run.loc)
    assert np.array_equal(core.obs.cpu().numpy(), run.obs)
    for key, codes in (("data_utm_tif", core.data_u16),
                       ("data_diag_utm_tif", core.diag_u16),
                       ("loc_utm_tif", core.loc_u16),
                       ("obs_utm_tif", core.obs_u16)):
        assert np.array_equal(run.tifs[key], codes.cpu().numpy()), key


def test_quantize_forms_on_the_utm_cube(ortho):
    """The quantize kernel against its plain version on the f32 run's UTM
    cube: the reflectance form (validity in the kernel, sentinel 65535),
    the Pallas form (scalar lo/hi, a validity mask, sentinel 65535) and
    per-band OBS-like lo/hi (sentinel 0): no code differs."""
    from hyperres_torch.kernels.stats import strided_band_minmax

    cube = ortho["f32"].res.device_cube
    x2 = cube.reshape(-1, cube.shape[-1])
    valid = torch.isfinite(x2) & (x2 != NO_DATA_VALUE)
    lo_b, hi_b = strided_band_minmax(cube, NO_DATA_VALUE)
    hi_b = torch.where(hi_b <= lo_b, lo_b + 1e-6, hi_b)
    nod = {"nodata_src": NO_DATA_VALUE}
    for fn, a, kw in ((quantize_u16, (cube, 0.0, REFL_HI_EFF, None, 65535),
                       nod),
                      (pallas_quantize_u16, (x2, 0.0, REFL_HI_EFF, valid,
                                             65535), {}),
                      (quantize_u16, (cube, lo_b, hi_b, None, 0), nod)):
        form = {"form": "pallas"} if fn is pallas_quantize_u16 else {}
        got, want = fn(*a, **kw), quantize_u16_reference(*a, **kw, **form)
        assert int((got.view(torch.int16) != want.view(torch.int16)).sum()
                   ) == 0, fn.__name__


@pytest.mark.parametrize("bands", [None, ["B2", "B3", "B4"]])
def test_srf_on_the_utm_cube(granule, ortho, bands):
    """The SRF kernel on the f32 run's UTM cube at S = 13 (S2A) and S = 3
    (B2, B3, B4), with the valid-pixel mask: the tiled route, its
    shared-memory plan equal to the wrapper's mirror; at S = 13
    ``srf_synthesize_auto(use_pallas=True)`` launches the kernel once to
    an (H, W, S) cube; the tiled kernel and the file's earlier warp
    kernel (forced by a stand-in route rule, one launch under its
    counter) within SRF_TOL of the plain version, the fill exact."""
    from hyperres_torch.io.granule import EmitGranule
    from hyperres_torch.kernels._build import load_library
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.spectral.srf_tables import builtin_srf

    cube = ortho["f32"].res.device_cube
    h, w, b = cube.shape
    with EmitGranule(granule.scene.emit_nc_path) as g:
        W, _, _ = build_srf_weight_matrix(
            np.asarray(g.wavelengths), builtin_srf("S2A", bands=bands),
            g.good_wavelengths)
    Wt = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(cube.device)
    s = Wt.shape[1]
    assert srf.srf_route(b, s)[0] == srf.TILED
    lib = load_library("srf_synthesize")
    for r in (2, 1):
        assert lib.srf_tiled_smem_bytes(b, s, r) == srf._tiled_smem_bytes(
            b, s, r)
    valid_hw = (cube != NO_DATA_VALUE).all(dim=-1)
    if bands is None:
        out, counts = counted(lambda: srf.srf_synthesize_auto(
            cube, Wt, valid_hw, use_pallas=True))
        assert tuple(out.shape) == (h, w, s)
        assert counts == {srf.KERNEL_NAME: 1}, counts
        del out
    flat, v = cube.reshape(-1, b), valid_hw.reshape(-1)
    want = srf.srf_synthesize_reference(flat, Wt, v)
    rule = srf.srf_route
    for route in (srf.TILED, srf.WARP):
        if route == srf.WARP:
            srf.srf_route = lambda b, s: (srf.WARP, 0)
        try:
            got, counts = counted(lambda: srf.pallas_srf_synthesize(flat, Wt,
                                                                    v))
        finally:
            srf.srf_route = rule
        assert counts == {srf.ROUTE_NAMES[route]: 1}, counts
        assert float((got - want).abs().max()) <= SRF_TOL, route
        assert torch.equal(got[~v], want[~v])
        assert bool((got[~v] == NO_DATA_VALUE).all())
