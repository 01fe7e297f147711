"""The port's host I/O copies and streamed ingest against the JAX
package on the CPU: the HDF5 / granule readers, GeoTIFF, ENVI and XML
writers and readers, the synthetic scene factory, the slab quantizers,
``dequant_slab``, ``stream_cube_to_device`` and ``PrefetchToDevice``.
Inputs are made from a seed and given to both. The CUDA placement of
``PrefetchToDevice`` runs only on a card (marked ``gpu``)."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from hyperres.io import envi as jenvi  # noqa: E402
from hyperres.io import ingest as jingest  # noqa: E402
from hyperres.io import tiff as jtiff  # noqa: E402
from hyperres.io import xml_sidecar as jxml  # noqa: E402
from hyperres.io.granule import EmitGranule as JGranule  # noqa: E402
from hyperres.io.granule import EmitMaskGranule as JMaskGranule  # noqa: E402
from hyperres.io.hdf5 import HDF5File as JHDF5File  # noqa: E402
from hyperres.testing import scenes as jscenes  # noqa: E402
from hyperres_torch.core.crs import CRS  # noqa: E402
from hyperres_torch.core.grid import Grid  # noqa: E402
from hyperres_torch.io import envi as tenvi  # noqa: E402
from hyperres_torch.io import ingest as tingest  # noqa: E402
from hyperres_torch.io import pipeline as tpipeline  # noqa: E402
from hyperres_torch.io import tiff as ttiff  # noqa: E402
from hyperres_torch.io import xml_sidecar as txml  # noqa: E402
from hyperres_torch.io.granule import EmitGranule, EmitMaskGranule  # noqa: E402
from hyperres_torch.io.hdf5 import HDF5File  # noqa: E402
from hyperres_torch.testing import scenes as tscenes  # noqa: E402

T = torch.from_numpy
GRID = Grid(CRS.utm(33, True), 399960.0, 5800020.0, 60.0, 60.0, 37, 29)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The port's synthetic granule (deflate-compressed, the default)."""
    return tscenes.make_scene(tmp_path_factory.mktemp("ioscene"),
                              raw_shape=(40, 48), n_bands=37, s2_size=200)


def _walk(node, prefix=""):
    """(path, attrs) of every group and (path, array, attrs) of every
    dataset of an HDF5 tree."""
    out = {}
    for name, ds in node.datasets.items():
        out[prefix + "/" + name] = (ds.read(), dict(ds.attrs))
    for name, grp in node.groups.items():
        out[prefix + "/" + name] = dict(grp.attrs)
        out.update(_walk(grp, prefix + "/" + name))
    return out


def _assert_attrs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_scene_copy_writes_the_reference_granule(scene, tmp_path):
    """The port's make_scene writes the granule and S2 stack that the
    reference's writes, byte for byte, and make_mask_granule too."""
    ref = jscenes.make_scene(tmp_path / "ref", raw_shape=(40, 48),
                             n_bands=37, s2_size=200)
    assert (scene.emit_nc_path.read_bytes()
            == ref.emit_nc_path.read_bytes())
    assert scene.s2_tif_path.read_bytes() == ref.s2_tif_path.read_bytes()
    bm = np.random.default_rng(0).random((40, 48, 37)) > 0.9
    a = tscenes.make_mask_granule(tmp_path / "m1.nc", (40, 48), n_bands=37,
                                  cloud_mask=bm[..., 0], band_mask=bm)
    b = jscenes.make_mask_granule(tmp_path / "m2.nc", (40, 48), n_bands=37,
                                  cloud_mask=bm[..., 0], band_mask=bm)
    assert a.read_bytes() == b.read_bytes()


def test_hdf5_and_granule_readers_match(scene, tmp_path):
    """HDF5File and EmitGranule read the same arrays and attributes as
    the reference's readers (array_equal), band slabs included; the mask
    granule reader too."""
    with HDF5File(scene.emit_nc_path) as f, \
            JHDF5File(scene.emit_nc_path) as jf:
        _assert_attrs_equal(f.attrs, jf.attrs)
        got, want = _walk(f.root), _walk(jf.root)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            if isinstance(v, dict):
                _assert_attrs_equal(v, want[k])
            else:
                np.testing.assert_array_equal(v[0], want[k][0])
                _assert_attrs_equal(v[1], want[k][1])
    with EmitGranule(scene.emit_nc_path) as g, \
            JGranule(scene.emit_nc_path) as jg:
        for a in ("product", "raw_height", "raw_width", "n_bands",
                  "geotransform", "time_coverage_start", "band_names"):
            assert getattr(g, a) == getattr(jg, a)
        for a in ("wavelengths", "fwhm", "good_wavelengths", "glt"):
            np.testing.assert_array_equal(getattr(g, a), getattr(jg, a))
        assert g.ortho_grid.geotransform == jg.ortho_grid.geotransform
        np.testing.assert_array_equal(g.read_bands(5, 30),
                                      jg.read_bands(5, 30))
        np.testing.assert_array_equal(g.location("elev"),
                                      jg.location("elev"))
    bm = np.random.default_rng(1).random((40, 48, 37)) > 0.8
    path = tscenes.make_mask_granule(tmp_path / "m.nc", (40, 48),
                                     n_bands=37, cloud_mask=bm[..., 1],
                                     band_mask=bm)
    with EmitMaskGranule(path) as m, JMaskGranule(path) as jm:
        np.testing.assert_array_equal(m.quality_mask((0, 1, 3)),
                                      jm.quality_mask((0, 1, 3)))
        np.testing.assert_array_equal(m.band_mask(), jm.band_mask())


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_geotiff_write_decodes_in_both_readers(dtype, tmp_path, rng):
    """write_geotiff (stdlib zlib per block where the reference uses its
    native codec) -> both TiffReaders decode the same pixels, grid,
    nodata, tags and descriptions as the reference writer's file."""
    data = rng.integers(0, 65535, (3, 29, 37)).astype(dtype)
    kw = dict(nodata=0, compress="deflate", predictor=2, tiled=True,
              descriptions=["a", "b", "c"], tags={"scale_factor": "1e-4"},
              band_tags=[{"scale": "2"}, {"scale": "3"}, {"scale": "4"}])
    ttiff.write_geotiff(tmp_path / "t.tif", data, GRID, **kw)
    jtiff.write_geotiff(tmp_path / "j.tif", data, GRID, **kw)
    for reader in (ttiff.TiffReader, jtiff.TiffReader):
        for name in ("t.tif", "j.tif"):
            with reader(tmp_path / name) as r:
                np.testing.assert_array_equal(r.read(), data)
                assert r.nodata == 0 and r.descriptions == ["a", "b", "c"]
                assert r.dataset_tags["scale_factor"] == "1e-4"
                assert [t["scale"] for t in r.band_tags] == ["2", "3", "4"]
                assert r.grid.geotransform == GRID.geotransform
    a, ga, na = ttiff.read_geotiff(tmp_path / "j.tif")
    np.testing.assert_array_equal(a, data)
    assert na == 0 and ga.geotransform == GRID.geotransform


def test_envi_and_xml_round_trip(tmp_path, rng):
    """ENVI cubes and headers and the XML sidecar: the port's writers
    produce the reference writers' files, and each package reads the
    other's back equal."""
    cube = rng.random((29, 37, 4)).astype(np.float32)
    extra = {"description": "x", "wavelength": [400.0, 500.0, 600.0, 700.0]}
    for mod, name in ((tenvi, "t"), (jenvi, "j")):
        mod.write_cube(tmp_path / f"{name}.bin", cube, GRID,
                       interleave="bil", nodata=-9999.0, extra_header=extra)
    for ext in (".bin", ".hdr"):
        assert ((tmp_path / f"t{ext}").read_bytes()
                == (tmp_path / f"j{ext}").read_bytes())
    r = tenvi.EnviReader(tmp_path / "j.hdr")
    np.testing.assert_array_equal(r.read(), cube)
    assert r.grid.geotransform == GRID.geotransform and r.nodata == -9999.0
    np.testing.assert_array_equal(
        jenvi.EnviReader(tmp_path / "t.hdr").read(), cube)
    kw = dict(product="L2A_RFL", epsg_str="EPSG:32633",
              crs_wkt=GRID.crs.to_wkt(), pixel_size=(60.0, 60.0),
              shape=(29, 37, 4), start_time_utc="2023-08-19T11:01:26+0000",
              end_time_utc="", bbox_lonlat=[[14.0, 52.0], [14.1, 52.0]],
              wavelengths=[400.0, 500.0, 600.0, 700.0], description="x")
    txml.write_xml_sidecar(str(tmp_path / "t.bin"), **kw)
    jxml.write_xml_sidecar(str(tmp_path / "j.bin"), **kw)
    assert ((tmp_path / "t.xml").read_text()
            == (tmp_path / "j.xml").read_text())


def _slab(rng, shape=(13, 17, 7)):
    x = rng.random(shape).astype(np.float32) * 0.9
    x[0, 0, 0] = np.nan
    x[1, 2, 3] = -9999.0
    x[..., 5] = -9999.0          # a band with no valid pixel
    return x


@pytest.mark.parametrize("nb", [7, 6])
def test_slab_quantizers_match(nb, rng):
    """quantize_slab_u16 / _u12 (verbatim host copies) == the
    reference's, array_equal, odd and even band counts."""
    x = _slab(rng, (13, 17, nb))
    for a, b in zip(tingest.quantize_slab_u16(x),
                    jingest.quantize_slab_u16(x)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tingest.quantize_slab_u12(x),
                    jingest.quantize_slab_u12(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("transfer", ["u16", "u12"])
def test_dequant_slab_matches(transfer, rng):
    """dequant_slab == the reference's within 1 ulp (XLA may contract
    q * scale + offset into an FMA); the nodata pixels exactly."""
    x = _slab(rng)
    q = (tingest.quantize_slab_u16(x) if transfer == "u16"
         else tingest.quantize_slab_u12(x)[:3])
    got = tingest.dequant_slab(tuple(T(np.asarray(v)) for v in q),
                               transfer, -9999.0).numpy()
    want = np.asarray(jingest.dequant_slab(
        tuple(jnp.asarray(v) for v in q), transfer, -9999.0))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got == -9999.0, want == -9999.0)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("transfer", ["f32", "u16", "u12"])
def test_stream_cube_to_device_matches(transfer, rng):
    """stream_cube_to_device == the reference's: f32 bit-equal, u16 /
    u12 within 1 ulp (the dequant's FMA); an odd tail chunk."""
    cube = _slab(rng, (11, 9, 45))

    def read(b0, b1):
        return cube[..., b0:b1]

    got = tingest.stream_cube_to_device(read, cube.shape, transfer=transfer,
                                        chunk_bands=16, device="cpu")
    want = np.asarray(jingest.stream_cube_to_device(
        read, cube.shape, transfer=transfer, chunk_bands=16))
    got = got.numpy()
    if transfer == "f32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got == -9999.0, want == -9999.0)
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_stream_cube_fold_payload_mode(rng):
    """payload_mode hands the fold the raw payload; its dequantized
    slabs equal the slab mode's, the tail chunk unpadded."""
    cube = _slab(rng, (5, 6, 20))
    seen = {}

    def fold_payload(carry, payload, b0):
        seen[b0] = tingest.dequant_slab(payload, "u16", -9999.0)
        return carry + 1

    def fold_slab(carry, x, b0):
        assert torch.equal(x, seen[b0])
        return carry + 1

    n = tingest.stream_cube_fold(lambda a, b: cube[..., a:b], cube.shape,
                                 fold_payload, 0, chunk_bands=8,
                                 payload_mode=True, device="cpu")
    m = tingest.stream_cube_fold(lambda a, b: cube[..., a:b], cube.shape,
                                 fold_slab, 0, chunk_bands=8, device="cpu")
    assert n == m == 3 and sorted(seen) == [0, 8, 16]
    assert seen[16].shape[-1] == 4
    with pytest.raises(ValueError):
        tingest.stream_cube_fold(lambda a, b: cube, cube.shape, fold_slab, 0,
                                 transfer="f16", device="cpu")


def test_prefetch_early_exit_and_errors():
    """A consumer that breaks early releases the loader thread (it does
    not stay blocked on the full queue) and the source is closed; a
    loader exception is re-raised at the consumer; a second iteration
    raises."""
    closed = threading.Event()

    def source():
        try:
            for i in range(1000):
                yield np.full((2, 2), i, np.float32)
        finally:
            closed.set()

    p = tpipeline.PrefetchToDevice(source(), depth=2, device="cpu")
    for i, x in enumerate(p):
        assert float(x[0, 0]) == i
        if i == 3:
            break
    p._thread.join(timeout=10)
    assert not p._thread.is_alive() and closed.is_set()
    with pytest.raises(RuntimeError, match="single-use"):
        next(iter(p))

    def failing():
        yield np.zeros(3, np.float32)
        raise KeyError("bad chunk")

    got = []
    with pytest.raises(KeyError, match="bad chunk"):
        for x in tpipeline.PrefetchToDevice(failing(), device="cpu"):
            got.append(x)
    assert len(got) == 1


def test_prefetch_batches_and_readers(rng):
    """Nested batches keep their structure (arrays become tensors,
    scalars stay on the host); band_chunk_reader and tile_batch_reader
    match the reference's."""
    items = [(np.arange(3, dtype=np.float32), np.int32(i),
              {"k": np.ones(2)}) for i in range(4)]
    out = list(tpipeline.PrefetchToDevice(iter(items), device="cpu"))
    assert [int(b) for _, b, _ in out] == [0, 1, 2, 3]
    assert isinstance(out[0][0], torch.Tensor)
    assert isinstance(out[0][2]["k"], torch.Tensor)
    from hyperres.io import pipeline as jpipeline

    arr = rng.random((4, 5, 70)).astype(np.float32)
    for a, b in zip(tpipeline.band_chunk_reader(
            lambda s, e: arr[..., s:e], 70, 32),
            jpipeline.band_chunk_reader(lambda s, e: arr[..., s:e], 70, 32)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_prefetch_cuda_buffers_outlive_their_use(cuda):
    """On the card, with a consumer that keeps its stream busy before it
    reads each batch: every batch arrives intact (the pinned buffer
    outlives its copy; the side-stream tensor is record_stream'd, so the
    allocator does not hand it to a later copy)."""
    n, shape = 24, (1024, 1024)

    def source():
        for i in range(n):
            yield np.full(shape, i, np.float32)

    sums = []
    for x in tpipeline.PrefetchToDevice(source(), depth=3, device=cuda):
        torch.cuda._sleep(2_000_000)
        sums.append(x.sum())
        del x
    torch.cuda.synchronize()
    assert [float(s) for s in sums] == [float(i * shape[0] * shape[1])
                                        for i in range(n)]
