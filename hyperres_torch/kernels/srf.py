"""SRF band synthesis as one band-mixing product (``hyperres/kernels/srf.py:108``).

Both trapezoid integrals of the reference are linear in the spectrum,
so the synthesis is ``(H*W, B) @ (B, S)`` with the host-built weight
matrix (``kernels.host.build_srf_weight_matrix``).

- :func:`srf_synthesize`: the fused plan's synthesis. The reference
  leaves this product to XLA outside any Pallas kernel; here it is a
  plain f32 ``torch.matmul`` (TF32 off, :mod:`hyperres_torch.device`).
- :func:`pallas_srf_synthesize`: the product with the invalid-row fill,
  ``out[n, s] = valid[n] ? sum_b x[n, b] W[b, s] : fill`` in f32, which
  replaces ``pallas_srf_synthesize`` (``hyperres/kernels/pallas_ops.py:70``).
  On a CUDA tensor the wrapper launches the hand-written kernel
  ``csrc/srf_synthesize.cu`` (or raises), for any B and S, by the route
  :func:`srf_route` picks from the shape: the tiled kernel (bulk
  asynchronous copies of whole row tiles, a thread per row) or, for
  band counts it does not take, the warp kernel (B <= 384, S <= 16) or
  the generic one (a warp per row, any shape); on a
  CPU tensor it runs :func:`srf_synthesize_reference`, the plain PyTorch
  version.
- :func:`srf_synthesize_auto`: the reference's dispatcher
  (``pallas_ops.py:172``): the kernel with ``use_pallas=True``, the
  matmul otherwise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..core.constants import NO_DATA_VALUE
from ..device import count_launch

#: the routes (csrc/srf_synthesize.cu)
TILED, GENERIC, WARP = "tiled", "generic", "warp"
#: launch-counter names: the tiled route's, and one for each other route
KERNEL_NAME = "srf_synthesize"
ROUTE_NAMES = {TILED: KERNEL_NAME, WARP: "srf_synthesize_warp",
               GENERIC: "srf_synthesize_generic"}
#: the limits of the warp route, the file's first kernel (kMaxS, kMaxB)
WARP_MAX_OUT_BANDS = 16
WARP_MAX_IN_BANDS = 384
#: shared memory a block may use on Hopper, and the tiled kernel's plan
#: (tiled_plan): 8 consumer warps, a ring of 2 tiles
_MAX_SMEM = 232448
_CONSUMER_WARPS = 8
_RING = 2


def _tiled_smem_bytes(b: int, s: int, rows_per_thread: int) -> int:
    """Shared memory of the tiled kernel (csrc/srf_synthesize.cu:
    tiled_plan): barriers and flags, W padded to a multiple of 4 columns
    (16 past S = 16), the 8 warps' partial sums of a tile, the ring."""
    tr = 32 * rows_per_thread
    sp = -(-s // 4) * 4 if s <= 16 else 16 * -(-s // 16)
    slot = -(-(tr * b + 8) // 4) * 4
    off_w = -(-(64 + _RING * tr + tr) // 16) * 16
    off_ring = -(-(off_w + b * sp * 4 + _CONSUMER_WARPS * tr * s * 4)
                 // 16) * 16
    return off_ring + _RING * slot * 4


def srf_route(b: int, s: int) -> Tuple[str, int]:
    """The kernel route for (N, B) @ (B, S), by shape: ``("tiled", R)``
    with R = 2 or 1 rows per thread (tiles of 32 R rows), where the
    thread-per-row reads of a tile spread over the shared-memory banks
    (row pitch B with gcd(B, 32) <= 2; EMIT's 285 is odd) and the ring
    of 2 tiles, W and the partial sums fit in shared memory, R = 2
    first; else ``("warp", 0)``, the file's first kernel (a warp per 2-4
    rows, lanes along the bands), where it takes the shape (B <= 384,
    S <= 16); else ``("generic", 0)``. The warp kernel stays a route
    because the generic one is slower on the shapes both take
    (chip_smoke.py runs both on 200,000 rows at B = 244, S = 13: 0.117
    against 0.386 ms on an NVIDIA H100 80GB HBM3 at 700 W)."""
    if math.gcd(b, 32) <= 2:
        for r in (2, 1):
            if _tiled_smem_bytes(b, s, r) <= _MAX_SMEM:
                return TILED, r
    if b <= WARP_MAX_IN_BANDS and s <= WARP_MAX_OUT_BANDS:
        return WARP, 0
    return GENERIC, 0


def srf_synthesize(cube_hwb: torch.Tensor, weights_bs: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None,
                   fill_value: float = NO_DATA_VALUE) -> torch.Tensor:
    """(H, W, B) x (B, S) -> (H, W, S). ``valid_mask`` (H, W) optionally
    sets nodata pixels to ``fill_value``."""
    h, w, b = cube_hwb.shape
    out = torch.matmul(cube_hwb.reshape(-1, b), weights_bs)
    out = out.reshape(h, w, weights_bs.shape[1])
    if valid_mask is not None:
        out = out.masked_fill(~valid_mask[..., None], fill_value)
    return out


def _check(cube_flat: torch.Tensor, weights: torch.Tensor,
           valid: Optional[torch.Tensor]):
    """Validate the operands; returns (N, B, S)."""
    if cube_flat.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"cube_flat (N, B) and weights (B, S) must be 2-D, "
                         f"got {tuple(cube_flat.shape)} and "
                         f"{tuple(weights.shape)}")
    n, b = cube_flat.shape
    if weights.shape[0] != b:
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"{b} bands")
    for name, t in (("cube_flat", cube_flat), ("weights", weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if weights.device != cube_flat.device:
        raise ValueError(f"weights on {weights.device} but cube_flat on "
                         f"{cube_flat.device}")
    if valid is not None and (tuple(valid.shape) != (n,)
                              or valid.dtype != torch.bool
                              or valid.device != cube_flat.device):
        raise ValueError(f"valid must be a ({n},) bool tensor on "
                         f"{cube_flat.device}")
    return n, b, weights.shape[1]


def srf_synthesize_reference(cube_flat: torch.Tensor, weights: torch.Tensor,
                             valid: Optional[torch.Tensor] = None,
                             fill_value: float = NO_DATA_VALUE
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, B) @ (B, S) -> (N, S),
    rows where ``valid`` is False set to ``fill_value``."""
    _check(cube_flat, weights, valid)
    out = torch.matmul(cube_flat, weights)
    if valid is not None:
        out = out.masked_fill(~valid[:, None], fill_value)
    return out


def pallas_srf_synthesize(cube_flat: torch.Tensor, weights: torch.Tensor,
                          valid: Optional[torch.Tensor] = None,
                          fill_value: float = NO_DATA_VALUE) -> torch.Tensor:
    """(N, B) @ (B, S) with the invalid-row fill in the kernel
    (``pallas_ops.py:70``); returns (N, S) float32, for any B and S.
    The TPU tiling argument has no counterpart (nothing is padded). The
    launch counts under the route's name (``ROUTE_NAMES``)."""
    n, b, s = _check(cube_flat, weights, valid)
    if cube_flat.device.type == "cpu":
        return srf_synthesize_reference(cube_flat, weights, valid,
                                        fill_value)
    if cube_flat.device.type != "cuda":
        raise ValueError(f"no SRF kernel for device {cube_flat.device}")
    route, rows = srf_route(b, s)
    from ._build import load_library

    lib = load_library("srf_synthesize")
    fn = {TILED: lib.srf_synthesize_tiled_f32,
          GENERIC: lib.srf_synthesize_generic_f32,
          WARP: lib.srf_synthesize_warp_f32}[route]
    shape = (n, b, s, rows) if route == TILED else (n, b, s)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * (len(shape) - 1)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    x = cube_flat.contiguous()
    w = weights.contiguous()
    mask = None if valid is None else valid.contiguous()
    out = torch.empty((n, s), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                *shape, float(fill_value), stream)
    if rc != 0:
        raise RuntimeError(f"srf_synthesize kernel launch ({route} route) "
                           f"failed: CUDA error {rc}")
    count_launch(ROUTE_NAMES[route])
    return out


def srf_synthesize_auto(cube_hwb: torch.Tensor, weights_bs: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None,
                        fill_value: float = NO_DATA_VALUE,
                        use_pallas: bool = False) -> torch.Tensor:
    """SRF synthesis of (H, W, B) to (H, W, S): the kernel
    (:func:`pallas_srf_synthesize`) with ``use_pallas``, the matmul
    (:func:`srf_synthesize`) otherwise (``pallas_ops.py:172``)."""
    if not use_pallas:
        return srf_synthesize(cube_hwb, weights_bs, valid_mask,
                              fill_value=fill_value)
    h, w, b = cube_hwb.shape
    flat = cube_hwb.reshape(-1, b)
    v = valid_mask.reshape(-1) if valid_mask is not None else None
    out = pallas_srf_synthesize(flat, weights_bs, v, fill_value)
    return out.reshape(h, w, weights_bs.shape[1])
