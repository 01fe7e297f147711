"""The bench scene's fused plans at scale 1.0 on the card (the default,
``warp_kernel="pallas"``, ``ot_affine``, the tap loop), each against
``bench.py``'s gates (``bench_torch.accuracy_metrics`` and ``GATES``:
finite fraction > 0.3, max <= 1, pipeline PSNR >= 45 dB, SAM <= 0.01 rad,
method PSNR >= 28 dB) on its own ``s2_reference_10m``; the fused ortho
warp against its eager chain at the cells' shapes; and ``warp_two_pass``
with a nodata value on the scene's geographic cube."""

import pytest
import torch

import bench_torch
from card_inputs import KERNEL_TOL, assert_bits, counted, eager_orthowarp
from hyperres_torch.core.constants import NO_DATA_VALUE
from hyperres_torch.kernels.banded import DENSE_KERNEL_NAME, KERNEL_NAMES
from hyperres_torch.kernels.orthowarp import KERNEL_NAMES as FUSED_WARP
from hyperres_torch.kernels.upsample_apply import KERNEL_NAME as APPLY

pytestmark = pytest.mark.gpu

EXPECT_UTM = (1523, 1550, 285)
EXPECT_FUSED = (9140, 9309, 3)
#: the tap-loop plan's UTM cube against the two-pass plan's
#: (tests/test_verify_granule.py)
TAPLOOP_PSNR_GATE = 40.0
TAPLOOP_MASK_AGREEMENT = 0.999
#: the generic two-pass warp against the gather kernels away from holes:
#: the scanline-sheared kernel against the axis-aligned one
#: (tests/test_torch_resample.py states it for the "auto" rule)
TWO_PASS_GATHER_TOL = 2e-3


def run(plan, bench):
    """One call of ``plan`` on the resident inputs, shapes checked:
    (output, launch counts)."""
    out, counts = counted(lambda: plan(bench.raw, bench.s2,
                                       generator=plan.generator(0)))
    assert tuple(out["utm_cube"].shape) == EXPECT_UTM
    assert tuple(out["fused_10m"].shape) == EXPECT_FUSED
    return out, counts


def gates(plan, out, bench, method="ot_poly", gated=True):
    """bench.py's gates; with ``gated`` False only the finite fraction and
    the max (bench.py gates no other method than ot_poly)."""
    target = plan.s2_reference_10m(out["utm_cube"], bench.s2)
    acc = bench_torch.accuracy_metrics(out["fused_10m"], target,
                                       out["coeffs"], method)
    assert bench_torch.gates_met(acc, parametric=gated), acc


def test_default_plan(bench, base):
    """The default plan: EXPECT_UTM / EXPECT_FUSED, each fused ortho warp
    pass and the 10 m apply kernel launched once a call, bench.py's
    gates."""
    out, counts = base
    assert tuple(out["utm_cube"].shape) == EXPECT_UTM
    assert tuple(out["fused_10m"].shape) == EXPECT_FUSED
    assert all(counts.get(k) == 1 for k in (*FUSED_WARP.values(), APPLY)
               ), counts
    gates(bench.plan, out, bench)


def test_dense_plan(bench, card, base):
    """The ``warp_kernel="pallas"`` plan (the dense scanline route): two
    dense launches a call, bench.py's gates, its ``utm_cube`` within
    KERNEL_TOL of the default plan's with the same fill pixels."""
    plan = bench_torch.build_plan(bench.scene, card, warp_kernel="pallas")
    out, counts = run(plan, bench)
    assert counts.get(DENSE_KERNEL_NAME) == 2, counts
    gates(plan, out, bench)
    ref = base[0]["utm_cube"]
    assert torch.equal(out["utm_cube"] == -9999.0, ref == -9999.0)
    assert float((out["utm_cube"] - ref).abs().max()) <= KERNEL_TOL


def test_ot_affine_plan(bench, card):
    """The ``fusion_method="ot_affine"`` plan: shapes, (4, 3) parameters,
    finite fraction > 0.3 and max <= 1."""
    plan = bench_torch.build_plan(bench.scene, card,
                                  fusion_method="ot_affine")
    out, _ = run(plan, bench)
    assert tuple(out["coeffs"].shape) == (4, 3)
    gates(plan, out, bench, method="ot_affine", gated=False)


def test_taploop_plan(bench, card, base):
    """The ``warp_kernel="taploop"`` plan (``orthowarp_taploop``): no
    scanline launch, bench.py's gates, and the default plan's
    ``utm_cube`` against its own by ``cube_psnr_sam(erode=2)``: PSNR >=
    TAPLOOP_PSNR_GATE, mask agreement > TAPLOOP_MASK_AGREEMENT."""
    from hyperres_torch.kernels.stats import cube_psnr_sam

    plan = bench_torch.build_plan(bench.scene, card, warp_kernel="taploop")
    out, counts = run(plan, bench)
    assert not set(counts) & {*KERNEL_NAMES.values(), *FUSED_WARP.values()
                              }, counts
    gates(plan, out, bench)
    ref, utm = base[0]["utm_cube"], out["utm_cube"]
    _, p_db, _ = (float(v) for v in cube_psnr_sam(ref, utm,
                                                  fill=NO_DATA_VALUE,
                                                  erode=2))
    agree = float(((ref[..., 0] != NO_DATA_VALUE)
                   == (utm[..., 0] != NO_DATA_VALUE)).to(torch.float32)
                  .mean())
    assert p_db >= TAPLOOP_PSNR_GATE and agree > TAPLOOP_MASK_AGREEMENT, (
        p_db, agree)


@pytest.mark.parametrize("bands,masked", [(285, False), (285, True),
                                          (3, False), (11, False)])
def test_fused_warp_equals_the_eager_chain(bench, card, bands, masked):
    """At the cells' shapes (raw 1242 x 1280, ortho 1510 x 1534, UTM
    1523 x 1550) ``orthowarp_two_pass`` on the plan's GLT and fields, as
    ``rgb10.resident`` and ``ortho60.resident`` run it, equals the eager
    chain bit for bit: the DATA cube with the GLT validity, and with ~10 %
    of the raw pixels quality-flagged (``OrthoGeometry.masked_valid``);
    3 and 11 bands of it as the LOC and OBS warps. One launch of each
    fused pass a warp."""
    from hyperres_torch.kernels.warp import orthowarp_two_pass

    p = bench.plan
    valid = p._valid
    if masked:
        gen = torch.Generator(device=card).manual_seed(24)
        flagged = torch.rand(bench.raw.shape[0] * bench.raw.shape[1],
                             generator=gen, device=card) < 0.1
        valid = valid & ~flagged[p._flat_idx.long()]
    raw = bench.raw[..., :bands].contiguous()
    ops = (p._flat_idx, valid, p._wr, p._wc, p._cstar)
    got, counts = counted(lambda: orthowarp_two_pass(raw, *ops))
    assert counts == {name: 1 for name in FUSED_WARP.values()}, counts
    _, want = eager_orthowarp(raw, *ops, fill=NO_DATA_VALUE)
    assert_bits(got, want)
    assert bool((want == NO_DATA_VALUE).any())
    assert bool((want != NO_DATA_VALUE).any())


def test_warp_two_pass_with_nodata(bench, card):
    """``resample_to_grid``'s ``kernel="auto"`` rule on the scene's
    GLT-gathered geographic cube onto the UTM grid (1523 x 1550 x 285,
    cross-CRS), with a nodata value (one validity channel per band, 570
    channels through both passes): each scanline pass launched once; both
    passes of the kernel at these 570 channels within KERNEL_TOL of their
    plain version on the warp's own source and positions, over every
    pixel; and the result within TWO_PASS_GATHER_TOL of the gather
    kernels' where every tap of both reads a valid source (the valid
    weight mass is 1), 2 px inside that area's edge, over > 1e6 px."""
    from hyperres_torch.kernels.banded import (
        scanline_resample, scanline_resample_reference,
    )
    from hyperres_torch.kernels.glt import glt_gather
    from hyperres_torch.kernels.host import scanline_cstar, source_index_field
    from hyperres_torch.kernels.stats import erode_mask
    from hyperres_torch.kernels.warp import (
        resample_tensor_to_grid, two_pass_src_ext, warp_interpolate,
        warp_interpolate_chunked,
    )

    ortho = glt_gather(bench.raw, bench.plan._flat_idx, bench.plan._valid)
    grids = (bench.scene["ortho_grid"], bench.scene["utm60"])
    got, counts = counted(lambda: resample_tensor_to_grid(
        ortho, *grids, method="cubic", nodata=NO_DATA_VALUE,
        fill=NO_DATA_VALUE))
    assert counts == {name: 1 for name in KERNEL_NAMES.values()}, counts
    rows_np, cols_np = source_index_field(*grids)
    rows, cols, cstar = (torch.from_numpy(a).to(card) for a in (
        rows_np, cols_np, scanline_cstar(rows_np, cols_np, grids[0].height)))
    src = two_pass_src_ext(ortho, NO_DATA_VALUE)
    assert src.shape[-1] == 2 * EXPECT_UTM[-1]
    for axis, pos in ((1, cstar), (0, rows)):   # pass 2 on pass 1's output
        h = scanline_resample(src, pos, axis, "cubic")
        err = float((h - scanline_resample_reference(src, pos, axis,
                                                     "cubic")).abs().max())
        assert err <= KERNEL_TOL, (axis, err)
        src = h
    del src, h
    want = warp_interpolate_chunked(ortho, rows, cols, nodata=NO_DATA_VALUE,
                                    method="cubic", band_chunk=32)
    valid = ((got != NO_DATA_VALUE).all(dim=-1)
             & (want != NO_DATA_VALUE).all(dim=-1))
    # where every tap of both warps reads a valid source the valid weight
    # mass is 1: the validity plane warped as data, 2 px inside its edge
    # (beside the swath's edge the signed cubic weights leave a small mass
    # to divide by, another one in each warp, and the quotients part)
    vplane = (ortho[..., :1] != NO_DATA_VALUE).to(torch.float32)
    mass = warp_interpolate(vplane, rows, cols, method="cubic",
                            fill=0.0)[..., 0]
    inner = erode_mask(((mass - 1.0).abs() <= 1e-6) & valid, 2)
    err = float((got - want).abs()[inner].max())
    assert err <= TWO_PASS_GATHER_TOL and int(inner.sum()) > 10 ** 6, (
        err, int(inner.sum()))
