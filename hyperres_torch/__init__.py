"""hyperres_torch — the PyTorch / CUDA (Hopper) port of ``hyperres``.

The JAX package ``hyperres`` is the reference; this package mirrors its
module names (``kernels.warp`` <-> ``hyperres.kernels.warp`` ...) and
computes the same things with PyTorch on the CPU or on an NVIDIA H100.
It imports ``torch`` and never ``jax``; of ``hyperres`` it uses only the
framework-neutral ``hyperres.core`` (grids, CRS math, configs,
constants). NumPy host helpers that live in JAX modules of the
reference are carried as port-owned copies (``kernels.host``), held
equal to their originals by the tests.

Ported paths: the fused granule plan (``fusion.fused``, ``ot_poly``)
and the ridge spectral-SR model from fit to the u16 product
(``fusion.ridge_sr``; ``entry`` gives its forward step).

Hand-written kernels, built with ``nvcc`` at first use
(``kernels._build``):

- ``csrc/scanline_warp.cu``: the two-pass scanline warp
  (``kernels.banded``);
- ``csrc/sr_predict.cu``: the fused ridge-SR predict to u16, in the
  product and serving layouts (``kernels.sr_predict``).

On a CUDA tensor a kernel wrapper launches its kernel or raises; on a
CPU tensor it runs the kernel's plain PyTorch version.
"""

from . import device  # noqa: F401  (sets the f32 precision policy)

__version__ = "0.1.0"
