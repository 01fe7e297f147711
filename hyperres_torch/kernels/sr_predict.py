"""Fused ridge spectral-SR prediction to the u16 product: the kernel
behind ``RidgeSpectralSR.predict_cube_u16`` and the row-major serving
form.

``sr_predict_u16`` computes, for each pixel and output band,

    q = clip(rint(sigmoid(expand((x - mean) / std) @ W + intercept) * 1e4),
             0, 65534)

as uint16, and 65535 where the pixel is invalid, in one of two layouts:

- ``"cmajor"``: X (Bx, N) -> Q (By, N), the product layout
  (``predict_cube_u16`` takes (Bx, H, W));
- ``"rowmajor"``: X (N, Bx) -> Q (N, By), the serving layout.

Validity comes from ``valid`` (N,) bool when given; otherwise a pixel is
valid when all its bands are finite and, with ``nodata``, none is
within numpy's ``isclose`` of it (``|x - nodata| <= 1e-8 + 1e-5
|nodata|``, evaluated in float64 as numpy does for an f32 array and a
Python float).

It replaces ``pallas_sr_predict_u16_cmajor`` and
``pallas_sr_predict_u16`` (``hyperres/kernels/pallas_ops.py:828``,
``:725``), which compute the same function. On a CUDA tensor the
wrapper launches the hand-written kernel ``csrc/sr_predict.cu`` (or
raises); on a CPU tensor it runs :func:`sr_predict_u16_reference`, the
plain PyTorch version, which goes over the pixels in batches: gather
expansion, f32 matmul, sigmoid, ``quantize_reflectance_u16``.

The kernel does the contraction on the tensor cores in TF32, as three
terms (``A_hi B_hi + A_hi B_lo + A_lo B_hi`` with ``hi`` / ``lo`` the
round-to-nearest TF32 split), which keeps f32-level accuracy. Its K axis
is the monomials in pairs that share every factor but the last
(:func:`sr_pair_table`), so a thread forms two monomials from one prefix
product; W's rows follow that order, with zero rows for padding.

Two routes, chosen from the model's shape by :func:`sr_route` before any
launch. Resident (launch counter ``sr_predict_u16``): the kernel keeps
W's hi and lo for its band tile in shared memory, which limits the
number of K columns; :func:`sr_tile_bands` gives the tile (32 bands, or
16 for more columns) and :func:`sr_k_columns` the columns of a factor
table (Bx = 10: F = 285 at degree 3 takes 320 columns, F = 1000 at
degree 4 takes 1184). Streamed (counter ``sr_predict_u16_streamed``):
for more columns (Bx = 12 at degree 4, F = 1819, takes 2080) W is split
and laid out once per model in global memory (:func:`sr_w_slabs`) and
the kernel streams it through a ring of K-chunk slabs in shared memory.
Both walk K in the same order with the same arithmetic, so a model
gives the same codes on either. Together they take every model with
Bx <= 16 and degree <= 4 (:func:`kernel_takes`).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import count_launch, launch_error
from .lstsq import poly_expand, sigmoid
from .stats import quantize_reflectance_u16

#: launch-counter names of the two routes
KERNEL_NAME = "sr_predict_u16"
STREAMED_NAME = "sr_predict_u16_streamed"
RESIDENT, STREAMED = "resident", "streamed"
LAYOUTS = ("cmajor", "rowmajor")
#: the kernel's limits (csrc/sr_predict.cu: kMaxBx, kMaxDegree)
MAX_BANDS_IN = 16
MAX_DEGREE = 4
#: shared memory a CTA may use on Hopper, and the kernel's layout of it
#: (csrc/sr_predict.cu: kMaxSmem, smem_bytes): W hi and lo (8 bytes per
#: K column and band), a pair entry per two columns (8 bytes, 16 at degree
#: 4), the inputs' mean and std, and per warpgroup its inputs, validity
#: and staged u16 tile
_MAX_SMEM = 232448
_WARPGROUPS = 2
#: the streamed route (csrc/sr_predict.cu: kChunkK, kStages, kStreamBN):
#: slabs of 32 K columns x [W_hi | W_lo] of 32 bands, a ring of 4
_CHUNK_K = 32
_STAGES = 4
_STREAM_BANDS = 32


def _wg_bytes(bands: int) -> int:
    tile = 64
    return ((1 + MAX_BANDS_IN) * (tile + 8) * 4 + 2 * tile
            + -(-bands * (tile + 2) * 2 // 16) * 16)


def _smem_bytes(bands: int, k_cols: int, degree: int) -> int:
    pair = 8 if degree <= 3 else 16
    return (2 * bands * k_cols * 4 + k_cols // 2 * pair
            + 2 * MAX_BANDS_IN * 4 + _WARPGROUPS * _wg_bytes(bands))


def _smem_bytes_streamed(k_cols: int, degree: int) -> int:
    """The streamed route's shared memory: the ring of slabs, the pair
    entries (resident), mean and std, the warpgroups' scratch."""
    pair = 8 if degree <= 3 else 16
    return (_STAGES * 2 * _STREAM_BANDS * _CHUNK_K * 4 + k_cols // 2 * pair
            + 2 * MAX_BANDS_IN * 4 + _WARPGROUPS * _wg_bytes(_STREAM_BANDS))


def sr_route(k_cols: int, degree: int) -> Tuple[Optional[str], int]:
    """The kernel's route for ``k_cols`` K columns (a multiple of 32) at
    ``degree``, and its output bands per CTA: ``("resident", 32 or 16)``
    where W's hi and lo fit in shared memory (:func:`sr_tile_bands`),
    else ``("streamed", 32)`` where the ring and the pair entries fit
    (up to ~21,000 columns; 16 bands at degree 4 take ~5,600), else
    ``(None, 0)``."""
    bands = sr_tile_bands(k_cols, degree)
    if bands:
        return RESIDENT, bands
    if _smem_bytes_streamed(k_cols, degree) <= _MAX_SMEM:
        return STREAMED, _STREAM_BANDS
    return None, 0


def kernel_takes(n_inputs: int, degree: int) -> bool:
    """Whether the kernel takes a model of ``n_inputs`` bands at
    ``degree``: the limits of its input tile and its pair entries. Every
    such model has a route (F <= 4845 monomials)."""
    return 1 <= n_inputs <= MAX_BANDS_IN and 1 <= degree <= MAX_DEGREE


def sr_tile_bands(k_cols: int, degree: int) -> int:
    """Output bands per CTA of the kernel for ``k_cols`` K columns (a
    multiple of 32) at ``degree``: 32 when W's TF32 hi and lo for 32
    bands fit in shared memory with the rest, else 16, else 0 (not
    taken; 1632 columns at most at degree <= 3, 1600 at degree 4)."""
    for bands in (32, 16):
        if _smem_bytes(bands, k_cols, degree) <= _MAX_SMEM:
            return bands
    return 0


def sr_pair_table(factors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's K order for an (F, degree) factor table (entries are
    rows of [1, x_0, ..., x_{Bx-1}]). Each monomial is its factors other
    than the constant, multiplied left to right: a prefix (all but the
    last) times the last. Monomials with the same prefix are paired, in
    blocks of 8 as (i, i + 4), so that the four pairs of a k8 step read
    four rows that fall in different shared-memory banks; a monomial left
    over is paired with padding. The pairs are padded to a multiple of 16
    (32 K columns).

    Returns ``pairs`` (P, 4) int32 for degree <= 3 ((P, 5) at degree 4):
    the prefix rows padded with the constant row 0 to 2 (3), then the two
    last factors' rows; and ``src`` (2P,) int32: the W row (the monomial)
    of each K column, -1 for padding. Pair 4 s + t fills K columns 8 s + t
    and 8 s + t + 4. Multiplying by the constant 1 is exact, so each
    monomial's value is the plain version's."""
    fac = np.asarray(factors)
    width = 4 if fac.shape[1] <= 3 else 5
    groups = {}
    for m, row in enumerate(fac.tolist()):
        nz = [r for r in row if r != 0] or [0]
        prefix = tuple(nz[:-1]) + (0,) * (width - 1 - len(nz))
        groups.setdefault(prefix, []).append((m, nz[-1]))
    pairs = []
    for prefix, members in groups.items():
        for b0 in range(0, len(members), 8):
            blk = members[b0:b0 + 8]
            h = -(-len(blk) // 2)
            pairs += [(prefix, blk[i], blk[i + h] if i + h < len(blk)
                       else None) for i in range(h)]
    n_pairs = -(-len(pairs) // 16) * 16
    rows = np.zeros((n_pairs, width), np.int32)
    src = np.full(2 * n_pairs, -1, np.int32)
    for q, (prefix, a, b) in enumerate(pairs):
        rows[q, :width - 2] = prefix
        col = 8 * (q // 4) + q % 4
        rows[q, width - 2], src[col] = a[1], a[0]
        if b is not None:
            rows[q, width - 1], src[col + 4] = b[1], b[0]
    return rows, src


def sr_k_columns(factors: np.ndarray) -> int:
    """K columns of the kernel for a factor table: twice its pairs."""
    return 2 * sr_pair_table(factors)[0].shape[0]


#: per factor tensor (by id, with a weak reference that drops the entry
#: when the tensor goes): its version and its pair table on its device
_PAIRS: Dict[int, tuple] = {}


def _device_pairs(factors: torch.Tensor):
    """:func:`sr_pair_table` of ``factors`` as int32 tensors on its
    device, cached per tensor and version (one read back to the host per
    factor table)."""
    key = id(factors)
    hit = _PAIRS.get(key)
    if hit is None or hit[0]() is not factors or hit[1] != factors._version:
        rows, src = sr_pair_table(factors.cpu().numpy())
        hit = (weakref.ref(factors, lambda _, k=key: _PAIRS.pop(k, None)),
               factors._version,
               torch.from_numpy(rows).to(factors.device),
               torch.from_numpy(src).to(factors.device))
        _PAIRS[key] = hit
    return hit[2], hit[3]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as the kernel rounds it (``cvt.rna.tf32.f32``:
    10 mantissa bits, to nearest, ties away from zero): half of the 13
    dropped bits added to the magnitude through the int32 view, then the
    13 cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def sr_w_slabs(W: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """W (F, By) as the streamed route reads it: its rows in the kernel's
    K order (``src`` of :func:`sr_pair_table`, zero rows for padding),
    split into TF32 ``hi = rna(w)`` and ``lo = rna(w - hi)`` (the
    resident route's split, bit for bit) and laid out as
    ``(ceil(By / 32), K / 32, 2048)`` slabs: slab (jt, c) holds K columns
    [32 c, 32 c + 32) of B rows n < 32 (W_hi of band 32 jt + n, zero past
    By) and 32 + n (W_lo), element (n, k) at ``(n // 8) * 256 + (k // 4)
    * 32 + (n % 8) * 4 + k % 4``: the no-swizzle core-matrix layout the
    ``wgmma``s read, so a slab goes to shared memory as it is."""
    k_cols, by = src.shape[0], W.shape[1]
    bn = _STREAM_BANDS
    jt = -(-by // bn)
    wk = torch.zeros((k_cols, jt * bn), dtype=torch.float32, device=W.device)
    live = src >= 0
    wk[live, :by] = W[src[live].to(torch.int64)]
    hi = tf32_rna(wk)
    lo = tf32_rna(wk - hi)
    # (K, jt, 2 bn): B rows of a band tile, hi then lo
    b = torch.cat([hi.view(k_cols, jt, bn), lo.view(k_cols, jt, bn)], dim=2)
    # K = (chunk, k // 4, k % 4), rows = (n // 8, n % 8)
    b = b.view(k_cols // _CHUNK_K, _CHUNK_K // 4, 4, jt, 2 * bn // 8, 8)
    b = b.permute(3, 0, 4, 1, 5, 2).contiguous()
    return b.view(jt, k_cols // _CHUNK_K, 2 * bn * _CHUNK_K)


#: per W tensor (by id, with a weak reference that drops the entry when
#: the tensor goes): its version, the factor table's id and version, and
#: its slabs
_SLABS: Dict[int, tuple] = {}


def _device_slabs(W: torch.Tensor, factors: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """:func:`sr_w_slabs` of a model's W, cached per tensor and version
    (the split and layout run once per model)."""
    key = id(W)
    tag = (W._version, id(factors), factors._version)
    hit = _SLABS.get(key)
    if hit is None or hit[0]() is not W or hit[1] != tag:
        hit = (weakref.ref(W, lambda _, k=key: _SLABS.pop(k, None)), tag,
               sr_w_slabs(W, src))
        _SLABS[key] = hit
    return hit[2]


def _check(X: torch.Tensor, x_mean: torch.Tensor, x_std: torch.Tensor,
           W: torch.Tensor, intercept: torch.Tensor, factors: torch.Tensor,
           layout: str, valid: Optional[torch.Tensor]):
    """Validate the operands; returns (N, Bx, By)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if X.dim() != 2:
        raise ValueError(f"X must be 2-D, got {tuple(X.shape)}")
    bx, n = X.shape if layout == "cmajor" else X.shape[::-1]
    f, by = W.shape
    if tuple(x_mean.shape) != (bx,) or tuple(x_std.shape) != (bx,):
        raise ValueError(f"x_mean/x_std must be ({bx},), got "
                         f"{tuple(x_mean.shape)} / {tuple(x_std.shape)}")
    if tuple(intercept.shape) != (by,):
        raise ValueError(f"intercept must be ({by},), got "
                         f"{tuple(intercept.shape)}")
    if factors.dim() != 2 or factors.shape[0] != f:
        raise ValueError(f"factors must be ({f}, degree), got "
                         f"{tuple(factors.shape)}")
    for name, t in (("X", X), ("x_mean", x_mean), ("x_std", x_std),
                    ("W", W), ("intercept", intercept)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} on {t.device} but X on {X.device}")
    if factors.device != X.device:
        raise ValueError(f"factors on {factors.device} but X on {X.device}")
    if valid is not None and (tuple(valid.shape) != (n,)
                              or valid.dtype != torch.bool
                              or valid.device != X.device):
        raise ValueError(f"valid must be a ({n},) bool tensor on "
                         f"{X.device}")
    return n, bx, by


def valid_pixels(x: torch.Tensor, nodata: Optional[float]) -> torch.Tensor:
    """(B, Bx) -> (B,): all bands finite and none isclose to nodata."""
    ok = torch.isfinite(x).all(dim=1)
    if nodata is not None:
        tol = 1e-8 + 1e-5 * abs(float(nodata))
        near = (x.to(torch.float64) - float(nodata)).abs() <= tol
        ok &= ~near.any(dim=1)
    return ok


def sr_predict_u16_reference(X: torch.Tensor, x_mean: torch.Tensor,
                             x_std: torch.Tensor, W: torch.Tensor,
                             intercept: torch.Tensor, factors: torch.Tensor,
                             layout: str = "cmajor",
                             valid: Optional[torch.Tensor] = None,
                             nodata: Optional[float] = None,
                             batch_pixels: int = 200_000) -> torch.Tensor:
    """Plain PyTorch version of the kernel (see the module docstring),
    ``batch_pixels`` pixels at a time, so that the (batch, F) feature
    matrix is the largest temporary."""
    n, bx, by = _check(X, x_mean, x_std, W, intercept, factors, layout,
                       valid)
    Xp = X.T if layout == "cmajor" else X          # (N, Bx) view
    out = torch.empty((n, by) if layout == "rowmajor" else (by, n),
                      dtype=torch.uint16, device=X.device)
    idx = factors.to(torch.int64)
    for s in range(0, n, batch_pixels):
        x = Xp[s:s + batch_pixels]
        v = valid_pixels(x, nodata) if valid is None \
            else valid[s:s + batch_pixels]
        z = poly_expand((torch.nan_to_num(x) - x_mean) / x_std, idx) @ W
        q = quantize_reflectance_u16(sigmoid(z + intercept), v[:, None])
        if layout == "rowmajor":
            out[s:s + batch_pixels] = q
        else:
            out[:, s:s + batch_pixels] = q.T
    return out


def sr_predict_u16(X: torch.Tensor, x_mean: torch.Tensor,
                   x_std: torch.Tensor, W: torch.Tensor,
                   intercept: torch.Tensor, factors: torch.Tensor,
                   layout: str = "cmajor",
                   valid: Optional[torch.Tensor] = None,
                   nodata: Optional[float] = None,
                   batch_pixels: int = 200_000) -> torch.Tensor:
    """Fused SR prediction to u16 (see the module docstring). CUDA
    tensors go through the hand-written kernel (X may be any strided
    2-D view), CPU tensors through :func:`sr_predict_u16_reference`
    (``batch_pixels`` is its batch). ``factors`` is the (F, degree)
    table of :func:`~hyperres_torch.kernels.host.poly_factor_indices`."""
    n, bx, by = _check(X, x_mean, x_std, W, intercept, factors, layout,
                       valid)
    if X.device.type == "cpu":
        return sr_predict_u16_reference(X, x_mean, x_std, W, intercept,
                                        factors, layout, valid, nodata,
                                        batch_pixels)
    if X.device.type != "cuda":
        raise ValueError(f"no SR-predict kernel for device {X.device}")
    f, degree = factors.shape
    if not kernel_takes(bx, degree):
        raise ValueError(f"the kernel takes Bx <= {MAX_BANDS_IN} and "
                         f"degree <= {MAX_DEGREE}, got {bx} and {degree}")
    pairs, src = _device_pairs(factors)
    k_cols = 2 * pairs.shape[0]
    route, _ = sr_route(k_cols, degree)
    if route is None:
        raise ValueError(f"the kernel's pair entries do not fit shared "
                         f"memory: F = {f} monomials take {k_cols} K "
                         f"columns at degree {degree}")
    from ._build import load_library

    lib = load_library("sr_predict")
    mean, std = x_mean.contiguous(), x_std.contiguous()
    ic = intercept.contiguous()
    if route == RESIDENT:
        fn, name = lib.sr_predict_u16_f32, KERNEL_NAME
        model = (W.contiguous().data_ptr(), ic.data_ptr(), pairs.data_ptr(),
                 src.data_ptr())
    else:
        fn, name = lib.sr_predict_u16_streamed_f32, STREAMED_NAME
        slabs = _device_slabs(W, factors, src)
        model = (slabs.data_ptr(), ic.data_ptr(), pairs.data_ptr())
    fn.argtypes = ([ctypes.c_void_p] * (5 + len(model)) + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    mask = None if valid is None else valid.contiguous()
    if layout == "cmajor":
        out = torch.empty((by, n), dtype=torch.uint16, device=X.device)
        x_sb, x_sp = X.stride()
        q_sb, q_sp = out.stride()
    else:
        out = torch.empty((n, by), dtype=torch.uint16, device=X.device)
        x_sp, x_sb = X.stride()
        q_sp, q_sb = out.stride()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(X.data_ptr(), None if mask is None else mask.data_ptr(),
                mean.data_ptr(), std.data_ptr(), *model, out.data_ptr(), n,
                bx, by, pairs.shape[0], degree, x_sp, x_sb, q_sp, q_sb,
                int(nodata is not None),
                0.0 if nodata is None else float(nodata), stream)
    if rc != 0:
        raise launch_error(f"sr_predict_u16 kernel launch ({route} route)",
                           rc)
    count_launch(name)
    return out
