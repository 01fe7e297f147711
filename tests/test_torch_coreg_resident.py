"""The port's resident coregistration core (``hyperres_torch.coreg.granule``
``coregister_stack``, and ``coregister_local`` / ``deshift`` on tensors)
against the benchmark's plain reference (``benchmark/reference/coreg.py``)
on the CPU, at a small size: the coregistration cell's world
(``benchmark/harness/coreg_scene.py``) over a 170 x 180 raw swath, an S2
stack of 3 bands (B03, B04, B08) of 1261 x 1309 px displaced by an
affine field, 128 px windows every 150 px.

Tolerances (written; the reference computes the same float32 operations
in another order, and the tie points' windows are the same to the bit):

- tie points: the same candidates kept and the same used, exactly;
  (dy, dx) within ``SHIFT_TOL`` px, reliability within ``REL_TOL``;
- the affine field within ``SHIFT_TOL`` px at the footprint's corners;
- the u16 product: codes within one step where both are valid, at most
  ``DIFF_SHARE`` of them differing, the same valid mask where the
  reference holds it sure (its mass away from the threshold).

The core on NumPy arrays is the NumPy entry points' path, so there the
results are equal."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness.coreg_scene import (  # noqa: E402
    EMIT_NODATA, S2_NODATA, coreg_scene)
from benchmark.reference import coreg as ref  # noqa: E402
from hyperres_torch.core.config import CoregConfig  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.coreg import granule as tgranule  # noqa: E402
from hyperres_torch.coreg import local as tlocal  # noqa: E402
from hyperres_torch.io.tiff import TiffReader, write_geotiff  # noqa: E402
from hyperres_torch.kernels.warp import resample_to_grid  # noqa: E402

SHIFT_TOL = 1e-4
REL_TOL = 1e-3
DIFF_SHARE = 1e-3
CFG = dict(window_size=(128, 128), grid_res=150.0, max_points=500,
           max_shift=50, min_reliability=25.0, tie_point_filter_level=3,
           ransac_thresh_px=3.0)
BANDS = [1, 2, 3]  # B03, B04, B08 of the scene's stack


def _grid(g):
    return Grid(CRS.utm(g.crs.zone, g.crs.north), g.x0, g.y0, g.dx, g.dy,
                g.width, g.height)


@pytest.fixture(scope="module")
def scene():
    sc = coreg_scene([170, 180], 1, 2**33 + 7, torch.device("cpu"), bands=4)
    stack = sc["stacks"][0][BANDS].contiguous()
    descs = [sc["descriptions"][b] for b in BANDS]
    return {"emit": sc["emit"], "stack": stack, "descriptions": descs,
            "emit_grid": _grid(sc["utm60"]), "s2_grid": _grid(sc["s2_grid"]),
            "utm60": sc["utm60"], "s2": sc["s2_grid"],
            "affine": sc["affine"][0],
            "bandmap": tgranule.s2_bandmap_from_descriptions(descs)}


def run_core(sc, emit=None, stack=None, config=CoregConfig(**CFG), **kw):
    return tgranule.coregister_stack(
        {"B08": sc["emit"] if emit is None else emit}, sc["emit_grid"],
        sc["stack"] if stack is None else stack, sc["s2_grid"], config,
        s2_bandmap=sc["bandmap"], nodata_emit=EMIT_NODATA,
        nodata_s2=float(S2_NODATA), device="cpu", **kw)


@pytest.fixture(scope="module")
def core(scene):
    return run_core(scene)


@pytest.fixture(scope="module")
def want(scene):
    cfg = dict(CFG, window_size=list(CFG["window_size"]))
    return ref.coregister(scene["emit"], scene["utm60"], scene["stack"],
                          scene["s2"], cfg, scene["bandmap"]["B08"] - 1,
                          EMIT_NODATA, float(S2_NODATA))


def test_core_matches_the_plain_reference(core, want, scene):
    """The tie points, the affine and the u16 product against the
    reference, under the module's tolerances; the planted field is
    recovered to 0.5 px at the footprint's centre."""
    assert core["final"]["success"] and core["final"]["s2_code"] == "B08"
    res = core["result"]
    got = {(t.row, t.col): t for t in res.tie_points}
    kept = {(p["row"], p["col"]): p for p in want["points"] if p["kept"]}
    assert got.keys() == kept.keys()
    assert res.info["n_matched"] == len(kept) >= 30
    for k, p in kept.items():
        t = got[k]
        assert t.used == p["used"], k
        assert abs(t.dy - p["dy"]) <= SHIFT_TOL
        assert abs(t.dx - p["dx"]) <= SHIFT_TOL
        assert abs(t.reliability - p["rel"]) <= REL_TOL
    h, w = scene["stack"].shape[1:]
    corners = np.array([[0, 0, 1], [0, w - 1, 1], [h - 1, 0, 1],
                        [h - 1, w - 1, 1]], dtype=np.float64)
    assert np.abs(corners @ (res.affine - want["affine"]).T).max() <= SHIFT_TOL
    (a0, a1, a2), (b0, b1, b2) = scene["affine"]
    r, c = h / 2.0, w / 2.0
    fit = res.affine @ np.array([r, c, 1.0])
    assert abs(fit[0] - (a0 + a1 * r + a2 * c)) < 0.5
    assert abs(fit[1] - (b0 + b1 * r + b2 * c)) < 0.5

    q = core["shifted"]
    assert q.dtype == torch.uint16 and q.shape == scene["stack"].shape
    a, b = q.to(torch.int32), want["codes"].to(torch.int32)
    sure = want["sure"]
    va, vb = a != S2_NODATA, b != S2_NODATA
    assert int(((va != vb) & sure).sum()) == 0
    d = (a - b).abs()[va & vb & sure]
    assert int(d.max()) <= 1
    assert float((d != 0).float().mean()) <= DIFF_SHARE
    assert float(sure.float().mean()) > 0.999
    # the stripe and the swath's outside stay nodata
    assert bool((q[:, :10] == S2_NODATA).all())


def test_core_on_arrays_is_the_numpy_entry_points(scene, core):
    """The core given NumPy arrays equals ``coregister_local`` on the
    resampled band and ``deshift`` of the stack, cast to u16 as the
    product is written, and its tensor run."""
    emit = scene["emit"].numpy()
    stack = scene["stack"].numpy()
    out = run_core(scene, emit=emit, stack=stack)
    on_s2 = resample_to_grid(emit, scene["emit_grid"], scene["s2_grid"],
                             method="cubic", nodata=EMIT_NODATA, fill=np.nan,
                             device="cpu")
    assert isinstance(on_s2, np.ndarray)
    res = tlocal.coregister_local(on_s2, stack[2], CoregConfig(**CFG),
                                  tgt_nodata=float(S2_NODATA),
                                  lowpass_frac=1.0 / 6.0, device="cpu")
    assert [(t.row, t.col, t.dy, t.dx, t.reliability, t.used)
            for t in res.tie_points] == [
        (t.row, t.col, t.dy, t.dx, t.reliability, t.used)
        for t in out["result"].tie_points]
    np.testing.assert_array_equal(res.affine, out["result"].affine)
    shifted = tlocal.deshift(stack, res, nodata=float(S2_NODATA),
                             device="cpu")
    assert isinstance(shifted, np.ndarray) and shifted.dtype == np.float32
    codes = np.clip(np.nan_to_num(shifted, nan=float(S2_NODATA)), 0,
                    65535).astype(np.uint16)
    np.testing.assert_array_equal(out["shifted"].numpy(), codes)
    np.testing.assert_array_equal(core["shifted"].numpy(), codes)


def test_float_stack_keeps_float32(scene):
    """A float stack comes back float32 with the nodata value kept, the
    same values as the u16 path before its cast."""
    out = run_core(scene, stack=scene["stack"].to(torch.float32))
    q = out["shifted"]
    assert q.dtype == torch.float32
    codes = torch.nan_to_num(q, nan=float(S2_NODATA)).clamp(0, 65535)
    assert torch.equal(codes.to(torch.int32).to(torch.uint16).to(torch.int32),
                       run_core(scene)["shifted"].to(torch.int32))


@pytest.mark.parametrize("case", ["masked", "small", "rejected"])
def test_failures(scene, case):
    """Every window masked, too small an image, every point rejected:
    each attempt records the reference's error, no product."""
    stack, cfg, sub = scene["stack"], CoregConfig(**CFG), None
    if case == "masked":
        stack = torch.full_like(stack, S2_NODATA)
        err = "no usable matching windows"
    elif case == "small":
        g = scene["s2_grid"]
        sub = Grid(g.crs, g.x0, g.y0, g.dx, g.dy, 12, 10)
        stack = stack[:, :10, :12]
        err = "image too small for matching"
    else:
        cfg = CoregConfig(**dict(CFG, min_reliability=101.0))
        err = "all tie points rejected"
    out = tgranule.coregister_stack(
        {"B08": scene["emit"], "B04": scene["emit"]}, scene["emit_grid"],
        stack, sub or scene["s2_grid"], cfg, s2_bandmap=scene["bandmap"],
        nodata_emit=EMIT_NODATA, nodata_s2=float(S2_NODATA), device="cpu")
    assert out["shifted"] is None and out["result"] is None
    assert out["final"] == {"success": False, "error": "All attempts failed"}
    assert out["attempts"] == [{"s2_code": c, "success": False, "error": err}
                               for c in ("B08", "B04")]


def test_ladder_falls_back_to_b04(scene):
    """With no B08 in the stack the ladder records it and matches B04."""
    out = tgranule.coregister_stack(
        {"B08": scene["emit"], "B04": scene["emit"]}, scene["emit_grid"],
        scene["stack"], scene["s2_grid"], CoregConfig(**CFG),
        s2_bandmap={"B04": 2}, nodata_emit=EMIT_NODATA,
        nodata_s2=float(S2_NODATA), device="cpu")
    assert out["attempts"][0] == {
        "s2_code": "B08", "success": False,
        "error": "B08 not in S2 template descriptions"}
    assert out["final"]["s2_code"] == "B04"
    assert out["final"]["s2_match_band_1b"] == 2


@pytest.mark.parametrize("mode", ["affine", "idw", "tps"])
def test_shift_field_on_a_device_is_the_numpy_field(core, mode):
    """``shift_field`` with a device: the affine field bit-equal to the
    NumPy form; with IDW or TPS residuals within 1e-5 px (their sums run
    in another order)."""
    res = core["result"]
    kw = {} if mode == "affine" else {"local_residuals": True, "mode": mode}
    want = tlocal.shift_field(res, (90, 110), **kw)
    got = tlocal.shift_field(res, (90, 110), device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        if mode == "affine":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def test_deshift_keeps_a_tensor_on_its_device(scene, core):
    """``deshift`` of a tensor returns a float32 tensor (B, H, W) on the
    tensor's device, equal to the array path."""
    out = tlocal.deshift(scene["stack"], core["result"],
                         nodata=float(S2_NODATA))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(
        out.numpy(), tlocal.deshift(scene["stack"].numpy(), core["result"],
                                    nodata=float(S2_NODATA), device="cpu"))


def test_file_path_runs_the_core(scene, tmp_path, monkeypatch):
    """``coregister_s2_to_emit`` reads the GeoTIFFs, runs the core once
    and writes its product: the written u16 stack is the core's."""
    from hyperres_torch.testing.scenes import make_scene

    sc = make_scene(tmp_path / "nc", raw_shape=(8, 9), n_bands=24,
                    s2_size=60)
    from hyperres_torch.io.granule import EmitGranule

    with EmitGranule(sc.emit_nc_path) as g:
        nb = len(g.wavelengths)
    emit = np.repeat(scene["emit"].numpy()[None], nb, axis=0)
    write_geotiff(tmp_path / "emit.tif", emit, scene["emit_grid"],
                  nodata=EMIT_NODATA, compress=None)
    write_geotiff(tmp_path / "s2.tif", scene["stack"].numpy(),
                  scene["s2_grid"], nodata=float(S2_NODATA),
                  descriptions=scene["descriptions"], compress=None)
    calls = []
    real = tgranule.coregister_stack

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(tgranule, "coregister_stack", spy)
    out = tgranule.coregister_s2_to_emit(
        emit_ref_tif=tmp_path / "emit.tif", s2_tgt_tif=tmp_path / "s2.tif",
        emit_nc_path=sc.emit_nc_path, out_s2_tif=tmp_path / "out.tif",
        config=CoregConfig(**CFG), device="cpu")
    assert len(calls) == 1 and out["final"]["success"]
    assert set(out) == {"final", "attempts", "out_s2_tif"}
    assert out["final"]["s2_code"] == "B08"
    assert {"emit_match_band_1b", "emit_match_wl_nm"} <= set(out["final"])
    with TiffReader(tmp_path / "out.tif") as r:
        np.testing.assert_array_equal(r.read(), calls[0]["shifted"].numpy())


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_interp_matrix_is_the_host_weight_matrix(method):
    """The resample's weight matrices, scattered on the device from the
    host's taps, equal ``separable_weight_matrix`` bit for bit (taps off
    either edge, centres outside, the 60 m -> 10 m phases)."""
    from hyperres_torch.kernels.host import separable_weight_matrix
    from hyperres_torch.kernels.warp import _interp_matrix

    rng = np.random.default_rng(4)
    for idx in (np.linspace(-3.0, 52.0, 400), np.arange(300) / 6.0 - 0.4,
                rng.uniform(-2.0, 51.0, 100)):
        idx = idx.astype(np.float32)
        np.testing.assert_array_equal(
            _interp_matrix(idx, 50, method, torch.device("cpu")).numpy(),
            separable_weight_matrix(idx, 50, method))


#: index axes for the packed taps: fractional source indices into a
#: 50 px source
TAP_AXES = {
    "centres_outside": np.linspace(-3.0, 52.0, 400),
    "taps_off_both_ends": np.concatenate([np.linspace(-0.5, 1.2, 40),
                                          np.linspace(47.8, 49.5, 40)]),
    "upsample": np.arange(300) / 6.0 - 5.0 / 12.0,
    "downsample": np.arange(8) * 6.0 + 2.5,
    "scattered": np.random.default_rng(4).uniform(-2.0, 51.0, 100),
}


@pytest.mark.parametrize("axis", list(TAP_AXES))
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_packed_taps_are_the_host_weight_matrix(method, axis):
    """The resample kernel's packed taps (``sep_resample.axis_taps``),
    placed at ``start + t``, are ``separable_weight_matrix`` bit for bit:
    every non-zero entry, no other, taps dropped off either end, centres
    outside the source all 0; the sums are the weights' in tap order."""
    from hyperres_torch.kernels.host import separable_weight_matrix
    from hyperres_torch.kernels.sep_resample import TAPS, axis_taps

    idx = TAP_AXES[axis].astype(np.float32)
    taps = axis_taps(idx, 50, method)
    n = TAPS[method]
    assert taps.weights.shape == (n, len(idx))
    assert taps.start.min() >= 1 - n and taps.start.max() <= 49
    dense = np.zeros((len(idx), 50 + 2 * n), dtype=np.float32)
    for t in range(n):   # padded by n on both sides for dropped taps
        dense[np.arange(len(idx)), taps.start + n + t] = taps.weights[t]
    assert not dense[:, :n].any() and not dense[:, -n:].any()
    np.testing.assert_array_equal(dense[:, n:-n],
                                  separable_weight_matrix(idx, 50, method))
    sums = np.zeros(len(idx), dtype=np.float32)
    for t in range(n):
        sums += taps.weights[t]
    np.testing.assert_array_equal(taps.sums, sums)


@pytest.mark.parametrize("bands", [1, 3, 285])
@pytest.mark.parametrize("axis", ["upsample", "downsample", "cell"])
def test_tiles_stage_every_tap(axis, bands):
    """Each column tile the resample kernel stages holds every tap of its
    destinations (``start - lo`` and ``start + T - lo`` within the span),
    a tile's columns and bands fill at most the block's threads, and its
    stage fits the shared memory: up- and downsampling, 1 to 285
    bands."""
    from hyperres_torch.kernels import sep_resample as sr

    idx = {"upsample": np.arange(403) / 6.0 - 5.0 / 12.0,
           "downsample": np.arange(67) * 6.0 + 2.5,
           "cell": np.arange(9309) / 6.0 - 5.0 / 12.0}[axis]
    taps = sr.axis_taps(idx.astype(np.float32), 1550, "cubic")
    tr, te, bc, span, lo = sr.tile(taps, 389, bands)
    assert te * bc <= sr.THREADS and bc * -(-bands // bc) >= bands
    assert 1 <= tr <= sr.MAX_TILE_ROWS
    assert tr * span * bc * 8 <= sr.STAGE_BYTES
    assert len(lo) == -(-len(idx) // te)
    tile_of = np.arange(len(idx)) // te
    assert (taps.start >= lo[tile_of]).all()
    assert (taps.start + 4 <= lo[tile_of] + span).all()


@pytest.mark.parametrize("device,dtype,method,want", [
    ("cpu", torch.uint16, "cubic", False),
    ("cpu", torch.float32, "bilinear", False),
    ("cuda", torch.uint16, "nearest", False),
    ("cuda", torch.int16, "cubic", False),
    ("cuda", torch.float64, "cubic", False),
    ("cuda", torch.uint16, "cubic", True),
    ("cuda", torch.uint16, "bilinear", True),
    ("cuda", torch.float32, "cubic", True),
    ("cuda", torch.float32, "bilinear", True),
])
def test_deshift_dispatch_rule(device, dtype, method, want):
    """The deshift takes the kernel for a CUDA device, a uint16 or
    float32 stack and cubic or bilinear; the CPU, another dtype and
    ``nearest`` keep the eager chain (no card needed: the rule reads the
    device's type)."""
    from hyperres_torch.kernels.deshift_warp import takes_kernel

    assert takes_kernel(torch.device(device), dtype, method) is want


@pytest.mark.parametrize("out_dtype", [torch.uint16, torch.float32])
@pytest.mark.parametrize("nodata,local", [(float(S2_NODATA), False),
                                          (None, False),
                                          (float(S2_NODATA), True)])
def test_deshift_product_on_the_cpu_is_the_eager_chain(scene, core,
                                                       out_dtype, nodata,
                                                       local):
    """On the CPU ``deshift_product`` launches nothing and gives what the
    deshift gave before the kernel: the field plus the pixel grid, the
    stack as (H, W, B) float32, ``warp_interpolate_chunked`` (fill:
    nodata, else NaN), and for u16 NaN to nodata (0 without), the clamp
    and the truncation."""
    from hyperres_torch.device import launch_counts, reset_launch_counts
    from hyperres_torch.kernels.warp import warp_interpolate_chunked

    stack, res = scene["stack"][:, :300, :280].contiguous(), core["result"]
    b, h, w = stack.shape
    rows, cols = tlocal.shift_field(res, (h, w), local_residuals=local,
                                    device="cpu")
    rows += torch.arange(h, dtype=torch.float32)[:, None]
    cols += torch.arange(w, dtype=torch.float32)[None, :]
    img = stack.permute(1, 2, 0).to(torch.float32).contiguous()
    want = warp_interpolate_chunked(
        img, rows, cols, nodata=nodata, method="cubic",
        fill=float(np.float32(nodata)) if nodata is not None else np.nan)
    if out_dtype == torch.uint16:
        want = want.nan_to_num(nan=nodata if nodata is not None else 0.0)
        want = want.clamp(0, 65535).to(torch.int32).to(torch.uint16)
    want = want.permute(2, 0, 1).contiguous()
    reset_launch_counts()
    got = tlocal.deshift_product(stack, res, out_dtype, nodata=nodata,
                                 local_residuals=local)
    assert not launch_counts
    assert got.dtype == out_dtype and got.shape == (b, h, w)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
