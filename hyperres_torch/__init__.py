"""hyperres_torch — the PyTorch / CUDA (Hopper) port of ``hyperres``.

The JAX package ``hyperres`` is the reference; this package mirrors its
module names (``kernels.warp`` <-> ``hyperres.kernels.warp`` ...) and
computes the same things with PyTorch on the CPU or on an NVIDIA H100.
It imports ``torch``, never ``jax``, and nothing of ``hyperres``: what
it needs of the reference's framework-neutral modules are port-owned
copies, each naming its source and held equal to it by the tests —
``core`` (grids, CRS math, configs, constants, cube containers), the
host I/O of ``io`` (HDF5 granules, ENVI, GeoTIFF, XML sidecars, xlsx),
``testing.scenes``, the SRF tables and cache of ``spectral``, the NumPy
helpers of ``kernels.host``, ``artifacts`` (run layout, report,
metadata, manifest) and ``catalog.s2_stack``.

Ported paths: the fused granule plan (``fusion.fused``: four fusion
methods, SRF or box synthesis, two-pass or tap-loop warp), the ridge
spectral-SR model from fit to the u16 product (``fusion.ridge_sr``;
``entry`` gives its forward step), the phase-wise fusion API
(``fusion.ot``, ``fusion.histogram``, ``fusion.linear``), the ortho
export path (``ortho``: streamed u16 / u12 / f32 ingest by band chunks,
``io.ingest``, the chunked GLT warp or the two-step gather +
``kernels.warp.resample_to_grid``, and the quantized GeoTIFF products),
the 4-phase fusion by both engines (``pipeline.fuse_pair``), the
granule parity harness (``verify.verify_granule``), the SRF sources
and scene-level synthesis API (``spectral``), and the pairs pipeline
(``pipeline.run_pair_pipeline``: ortho, coregistration by batched FFT
phase correlation (``coreg``, ``kernels.phasecorr``), overlap crop,
fusion, paired tiling (``tiling``), the SR fit and 10 m product, the
run's artifacts (``artifacts``)), the batch driver over many pairs
(``batch``: resume, retries, one worker thread per device), the sharded
ops on a single-process device mesh (``parallel``: n shards on one card
or on n cards), the command line (``python -m hyperres_torch``, ``cli``),
host-only copies of the quicklooks and HTML viewer (``viz``), catalog
search and pair discovery (``catalog``: polygon geometry, the CMR and
STAC clients over injectable fetchers, SCL cloud metrics over HTTP range
reads of ``io.tiff``), the granule toolkit (``ortho.toolkit``: raw-space
subsets, browse orthos, and ``merge_emit``'s mosaic on the device) and
the stage timer and trace capture (``utils``). Every module of the
reference has its counterpart here, apart from ``native`` (the g++
codec: ``io.tiff`` deflates with zlib), ``utils.compile_cache`` (XLA's
cache) and ``parallel.introspect`` (it parses XLA HLO).

Hand-written kernels, built with ``nvcc`` at first use
(``kernels._build``):

- ``csrc/scanline_warp.cu``: the two-pass scanline warp, banded and
  dense routes (``kernels.banded``);
- ``csrc/sinkhorn_duals.cu``: the log-domain Sinkhorn sweeps, one read
  of the cost matrix per sweep, or two for rows too long to keep on
  chip (``kernels.sinkhorn_duals``);
- ``csrc/sr_predict.cu``: the fused ridge-SR predict to u16, in the
  product and serving layouts, its contraction on the tensor cores as
  three TF32 products (``kernels.sr_predict``);
- ``csrc/quantize_u16.cu``: float32 to u16 codes with a nodata sentinel,
  behind every u16 product (``kernels.quantize``);
- ``csrc/srf_synthesize.cu``: SRF band synthesis with the invalid-row
  fill (``kernels.srf``).

On a CUDA tensor a kernel wrapper launches its kernel or raises; on a
CPU tensor it runs the kernel's plain PyTorch version. The entry points
(plans, models, ``fusion``, ``ortho``, ``io.ingest``, ``pipeline``,
``verify``, ``kernels.warp.resample_to_grid``, ``spectral.synth``,
``coreg``, ``kernels.phasecorr``, ``tiling``, ``catalog.s2_stack``,
``ortho.toolkit.merge_emit``) take a
``device`` that defaults to the current CUDA device and raise where
there is none; ``device="cpu"`` asks for the CPU. So do
``parallel.make_mesh`` (its ``devices``), ``BatchPairDriver.run`` (its
``devices``) and the command line (``--device``).
"""

from . import device  # noqa: F401  (sets the f32 precision policy)

__version__ = "0.1.0"

from . import core

# subpackages are imported lazily on attribute access to keep bare
# `import hyperres_torch` light (the reference's list, less ``native``:
# the port has no g++-built codec)
_SUBMODULES = ("io", "kernels", "ortho", "spectral", "fusion", "coreg",
               "tiling", "parallel", "catalog", "artifacts", "viz",
               "testing", "pipeline", "batch", "cli", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'hyperres_torch' has no attribute {name!r}")


__all__ = ["core", "__version__", *_SUBMODULES]
