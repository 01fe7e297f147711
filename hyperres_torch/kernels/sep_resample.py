"""The same-CRS bilinear / cubic grid transfer as one kernel
(``csrc/sep_resample.cu``).

``sep_resample(arr, idx_r, idx_c, method, ...)`` computes, in one pass
over the (Hd, Wd, B) result, what the dense route of
:func:`~hyperres_torch.kernels.warp.resample_tensor_to_grid` computes
(``warp._interp_matrix`` and ``warp.separable_resample_matmul``):

- the taps of ``host.separable_tap_table`` on each axis, 4 (cubic) or 2
  (bilinear) per destination index, built on the host in O(Hd + Wd) by
  :func:`axis_taps` and sent up in one packed upload
  (:func:`device_taps`, then :func:`launch`); no dense (Dst, Src)
  matrix is made;
- the row pass, then the column pass, each tap one fused multiply-add in
  ascending source order from 0; with a nodata value the numerator from
  ``where(ok, v, 0)`` and the mass from ``ok`` (not nodata, finite)
  through the same taps; without one the mass is the product of the two
  axes' weight sums;
- ``num / mass`` where ``|mass| > 1e-6``, else ``fill``
  (``warp._renormalise``).

It equals the dense route on the card bit for bit where cuBLAS sums in
source order with one fused multiply-add a term (the coregistration's
1523 x 1550 -> 9140 x 9309 cubic transfer); elsewhere the two part by
the rounding of a sum in another order (``tests_gpu``). One departure:
without a nodata value a NaN or infinite source value reaches only the
outputs whose taps read it, where the dense products' ``0 * NaN`` spread
it over its whole source row and column, so over every output.

The kernel takes CUDA tensors only; the dense route stays the plain
version on the CPU, and :func:`takes_kernel` is the rule by which
``resample_tensor_to_grid`` chooses between them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.constants import NO_DATA_VALUE
from ..device import count_launch, launch_error
from .host import separable_tap_table

#: launch-counter name
KERNEL_NAME = "sep_resample"
#: ``resample_tensor_to_grid``'s counter of launches inside the caller's
#: open span (``coreg.resample`` in the coregistration)
RESAMPLE_COUNTER = "resample.kernel"
#: taps per destination index of each method
TAPS = {"bilinear": 2, "cubic": 4}
#: threads a block, and the shared memory its row-pass stage may take
#: (``csrc/sep_resample.cu``)
THREADS = 256
STAGE_BYTES = 48 * 1024
#: the most destination rows a tile takes (at the coregistration's
#: shapes on an H100: 8 rows 0.317 ms, 32 rows 0.254, 64 rows 0.244, 128
#: rows 0.267)
MAX_TILE_ROWS = 64
_INDEX_LIMIT = 2 ** 31 - 1


class AxisTaps(NamedTuple):
    """One axis's taps: ``start`` (Dst,) int32, the first source index;
    ``weights`` (T, Dst) float32, a dropped tap (off the source, or a
    destination centre outside it) 0; ``sums`` (Dst,) float32, the
    weights summed in tap order."""
    start: np.ndarray
    weights: np.ndarray
    sums: np.ndarray


def takes_kernel(device) -> bool:
    """Whether a same-CRS bilinear or cubic transfer of a tensor on
    ``device`` runs on the kernel: a CUDA device. The CPU keeps the dense
    route."""
    return torch.device(device).type == "cuda"


def axis_taps(idx_1d: np.ndarray, src_size: int, method: str) -> AxisTaps:
    """The nonzero entries of ``separable_weight_matrix(idx_1d, src_size,
    method)`` per destination index (``host.separable_tap_table``): tap t
    of destination d lies at source ``start[d] + t``. Starts are clipped
    to [1 - T, src_size - 1], which changes none whose centre lies in the
    source (their taps are all 0 otherwise), so that a tile's taps span
    few source indices."""
    first, weights, _ = separable_tap_table(idx_1d, src_size, method)
    n_taps = weights.shape[0]
    start = np.clip(first, 1 - n_taps, src_size - 1).astype(np.int32)
    sums = np.zeros(weights.shape[1], dtype=np.float32)
    for w in weights:
        sums += w
    return AxisTaps(start, weights, sums)


def tile(taps_c: AxisTaps, n_rows: int, n_bands: int):
    """The kernel's tile for a result of ``n_rows`` rows on the column
    taps ``taps_c`` with ``n_bands`` bands: (rows TR, columns TE, bands
    BC, staged source columns span, least start of each column tile).
    TE * BC fill the block's threads; TE halves, down to one, until at
    least min(4, rows) rows of the stage fit ``STAGE_BYTES``."""
    n_taps = taps_c.weights.shape[0]
    chunks = -(-n_bands // THREADS)
    bc = -(-n_bands // chunks)
    te = max(1, THREADS // bc)
    start = taps_c.start.astype(np.int64)
    while True:
        edges = np.arange(0, start.shape[0], te)
        lo = np.minimum.reduceat(start, edges)
        span = int((np.maximum.reduceat(start, edges) - lo).max()) + n_taps
        tr = min(MAX_TILE_ROWS, n_rows, STAGE_BYTES // (span * bc * 8))
        if tr >= min(4, n_rows) or te == 1:
            return tr, te, bc, span, lo.astype(np.int32)
        te //= 2


class DeviceTaps(NamedTuple):
    """Both axes' taps of one transfer on a device: ``buffer``, the one
    packed upload (start_r, start_c, the column tiles' least starts,
    w_r, w_c, sum_r, sum_c); ``ptrs``, the address of each part;
    ``shape`` (Hs, Ws, Hd, Wd, B); ``method``; ``tile`` (TR, TE, BC,
    span) of :func:`tile`."""
    buffer: torch.Tensor
    ptrs: tuple
    shape: tuple
    method: str
    tile: tuple


def device_taps(idx_r: np.ndarray, idx_c: np.ndarray, src_shape,
                method: str, device) -> DeviceTaps:
    """The taps (:func:`axis_taps`) of a transfer from a (Hs, Ws, B)
    source at the source indices ``idx_r`` (Hd,) / ``idx_c`` (Wd,), and
    the kernel's tile, sent to ``device`` in one upload."""
    hs, ws, b = src_shape
    taps_r = axis_taps(idx_r, hs, method)
    taps_c = axis_taps(idx_c, ws, method)
    tr, te, bc, span, lo_c = tile(taps_c, len(idx_r), b)
    parts = (taps_r.start, taps_c.start, lo_c, taps_r.weights,
             taps_c.weights, taps_r.sums, taps_c.sums)
    buffer = torch.from_numpy(np.concatenate(
        [p.reshape(-1).view(np.int32) for p in parts])).to(device)
    offsets = np.cumsum([0] + [p.size for p in parts[:-1]])
    return DeviceTaps(buffer, tuple(buffer.data_ptr() + 4 * int(o)
                                    for o in offsets),
                      (hs, ws, len(idx_r), len(idx_c), b), method,
                      (tr, te, bc, span))


def launch(arr: torch.Tensor, taps: DeviceTaps,
           nodata: Optional[float] = None,
           fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """One launch of the kernel on ``arr``, as :func:`sep_resample`
    checks it, with the taps ``taps`` made for its shape."""
    hs, ws, hd, wd, b = taps.shape
    if tuple(arr.shape) != (hs, ws, b) or taps.buffer.device != arr.device:
        raise ValueError(f"taps made for a ({hs}, {ws}, {b}) source on "
                         f"{taps.buffer.device}, got {tuple(arr.shape)} on "
                         f"{arr.device}")
    out = torch.empty((hd, wd, b), dtype=torch.float32, device=arr.device)
    nd = None if nodata is None else float(np.float32(nodata))
    from ._build import load_library

    fn = load_library("sep_resample").sep_resample
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 5
                   + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        rc = fn(arr.data_ptr(), out.data_ptr(), hs, ws, hd, wd, b,
                TAPS[taps.method], *taps.ptrs, *taps.tile,
                int(nd is not None), nd or 0.0, float(fill), stream)
    if rc != 0:
        raise launch_error("sep_resample kernel launch", rc)
    count_launch(KERNEL_NAME)
    return out


def sep_resample(arr: torch.Tensor, idx_r: np.ndarray, idx_c: np.ndarray,
                 method: str, nodata: Optional[float] = None,
                 fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """The (Hd, Wd, B) float32 transfer of ``arr`` (Hs, Ws, B) float32,
    contiguous on a CUDA device, at the fractional source indices
    ``idx_r`` (Hd,) / ``idx_c`` (Wd,) of ``host.separable_index_axes``
    (module docstring): :func:`device_taps`, then :func:`launch`. Raises
    ``ValueError`` / ``TypeError`` for anything else."""
    if arr.device.type != "cuda":
        raise ValueError(f"arr on {arr.device}: the resample kernel takes "
                         "CUDA tensors only")
    if arr.dtype != torch.float32:
        raise TypeError(f"arr must be float32, got {arr.dtype}")
    if arr.dim() != 3 or not arr.is_contiguous():
        raise ValueError(f"arr must be a contiguous (H, W, B) tensor, got "
                         f"{tuple(arr.shape)}")
    if method not in TAPS:
        raise ValueError(f"the kernel takes {tuple(TAPS)}, got {method!r}")
    hs, ws, b = arr.shape
    hd, wd = len(idx_r), len(idx_c)
    if max(hs, ws, hd, wd, b) > _INDEX_LIMIT:
        raise ValueError("each side and the band count must be below 2^31")
    if hd * wd * b == 0 or arr.numel() == 0:
        return torch.full((hd, wd, b), fill, dtype=torch.float32,
                          device=arr.device)
    return launch(arr, device_taps(idx_r, idx_c, arr.shape, method,
                                   arr.device), nodata, fill)
