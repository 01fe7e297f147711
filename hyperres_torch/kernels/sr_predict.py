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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..device import count_launch
from .lstsq import poly_expand, sigmoid
from .stats import quantize_reflectance_u16

#: launch-counter name
KERNEL_NAME = "sr_predict_u16"
LAYOUTS = ("cmajor", "rowmajor")
#: the kernel's limits (csrc/sr_predict.cu: kMaxBx, kMaxDegree)
MAX_BANDS_IN = 16
MAX_DEGREE = 4


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
    if bx > MAX_BANDS_IN or degree > MAX_DEGREE:
        raise ValueError(f"the kernel takes Bx <= {MAX_BANDS_IN} and "
                         f"degree <= {MAX_DEGREE}, got {bx} and {degree}")
    from ._build import load_library

    lib = load_library("sr_predict")
    fn = lib.sr_predict_u16_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    mean, std = x_mean.contiguous(), x_std.contiguous()
    Wc, ic = W.contiguous(), intercept.contiguous()
    fac = factors.to(torch.int32).contiguous()
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
                mean.data_ptr(), std.data_ptr(), Wc.data_ptr(),
                ic.data_ptr(), fac.data_ptr(), out.data_ptr(), n, bx, by,
                f, degree, x_sp, x_sb, q_sp, q_sb, int(nodata is not None),
                0.0 if nodata is None else float(nodata), stream)
    if rc != 0:
        raise RuntimeError(f"sr_predict_u16 kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(KERNEL_NAME)
    return out
