"""hyperres_torch — the PyTorch / CUDA (Hopper) port of ``hyperres``.

The JAX package ``hyperres`` is the reference; this package mirrors its
module names (``kernels.warp`` <-> ``hyperres.kernels.warp`` ...) and
computes the same things with PyTorch on the CPU or on an NVIDIA H100.
It imports ``torch``, never ``jax``, and nothing of ``hyperres``: what
it needs of the reference's framework-neutral modules are port-owned
copies, each naming its source and held equal to it by the tests —
``core`` (grids, CRS math, configs, constants), the host I/O of ``io``
(HDF5 granules, ENVI, GeoTIFF, XML sidecars, xlsx), ``testing.scenes``,
the SRF tables and cache of ``spectral`` and the NumPy helpers of
``kernels.host``.

Ported paths: the fused granule plan (``fusion.fused``: four fusion
methods, SRF or box synthesis, two-pass or tap-loop warp), the ridge
spectral-SR model from fit to the u16 product (``fusion.ridge_sr``;
``entry`` gives its forward step), the phase-wise fusion API
(``fusion.ot``, ``fusion.histogram``, ``fusion.linear``), the ortho
export path (``ortho``: streamed u16 / u12 / f32 ingest by band chunks,
``io.ingest``, the chunked GLT warp or the two-step gather +
``kernels.warp.resample_to_grid``, and the quantized GeoTIFF products),
the 4-phase fusion by both engines (``pipeline.fuse_pair``), the
granule parity harness (``verify.verify_granule``) and the SRF sources
and scene-level synthesis API (``spectral``).

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
``verify``, ``kernels.warp.resample_to_grid``, ``spectral.synth``) take a
``device`` that defaults to the current CUDA device and raise where
there is none; ``device="cpu"`` asks for the CPU.
"""

from . import device  # noqa: F401  (sets the f32 precision policy)

__version__ = "0.1.0"
