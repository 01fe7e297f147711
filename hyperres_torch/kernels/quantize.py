"""Float32 to uint16 quantization with a nodata sentinel: the kernel
behind ``stats.quantize_u16`` (every u16 GeoTIFF product) and
``pallas_quantize_u16``.

For values ``x`` whose last axis holds C bands, and band b's ``lo`` and
``hi`` (scalars, or (C,) tensors):

- ``form="stats"`` (``hyperres/kernels/stats.py:289``):
  ``s = (x - lo) / (hi - lo + 1e-32) * 65535``, all in float32;
- ``form="pallas"`` (``hyperres/kernels/pallas_ops.py:122``):
  ``s = (x - lo) * scale``, with ``scale = 65535 / (hi - lo + 1e-32)``
  computed in double from scalar ``lo``/``hi`` and rounded to float32.

Then ``q = clip(rint(s), q_lo, q_hi)`` (half to even), with ``q_lo = 1``
when the sentinel ``nodata_u16`` is 0 and ``q_hi = 65534`` when it is
65535, and ``q = nodata_u16`` where the element is invalid. Validity is
``valid`` (a bool tensor of x's shape) when given; otherwise
``isfinite(x)``, and ``x != nodata_src`` when ``nodata_src`` is given.
The two forms can differ by one step at a rounding tie, so each caller
gets its reference's bits.

It replaces ``pallas_quantize_u16`` (``pallas_ops.py:122``). On a CUDA
tensor the wrapper launches the hand-written kernel
``csrc/quantize_u16.cu`` (or raises); on a CPU tensor it runs
:func:`quantize_u16_reference`, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from ..device import count_launch

#: launch-counter name
KERNEL_NAME = "quantize_u16"
FORMS = ("stats", "pallas")

Bound = Union[float, torch.Tensor]


def _operands(x: torch.Tensor, lo: Bound, hi: Bound, form: str,
              valid: Optional[torch.Tensor]):
    """Validate; returns (lo (C,) or (1,), second operand (C,) or (1,))
    as float32 on x's device: hi for the stats form, scale for the
    pallas form."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("x must have at least one axis")
    if valid is not None and (valid.shape != x.shape
                              or valid.dtype != torch.bool
                              or valid.device != x.device):
        raise ValueError(f"valid must be a bool tensor of shape "
                         f"{tuple(x.shape)} on {x.device}")
    c = x.shape[-1]
    if form == "pallas":
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
            raise TypeError("the pallas form takes scalar lo and hi")
        scale = 65535.0 / (float(hi) - float(lo) + 1e-32)
        pair = (float(lo), scale)
    else:
        pair = (lo, hi)
    out = []
    for v in pair:
        t = torch.as_tensor(v, dtype=torch.float32, device=x.device)
        t = t.reshape(-1)
        if t.numel() not in (1, c):
            raise ValueError(f"lo/hi must be scalars or ({c},), got "
                             f"{tuple(t.shape)}")
        out.append(t)
    if out[0].numel() != out[1].numel():
        out = [t.expand(c) for t in out]
    return out[0], out[1]


def quantize_u16_reference(x: torch.Tensor, lo: Bound, hi: Bound,
                           valid: Optional[torch.Tensor] = None,
                           nodata_u16: int = 0, *, form: str = "stats",
                           nodata_src: Optional[float] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (see the module docstring)."""
    lo_t, p2 = _operands(x, lo, hi, form, valid)
    if form == "pallas":
        s = (x - lo_t) * p2
    else:
        s = (x - lo_t) / ((p2 - lo_t) + 1e-32) * 65535.0
    q_lo = 1.0 if nodata_u16 == 0 else 0.0
    q_hi = 65534.0 if nodata_u16 == 65535 else 65535.0
    q = torch.clamp(torch.round(s), q_lo, q_hi)
    if valid is None:
        valid = torch.isfinite(x)
        if nodata_src is not None:
            valid &= x != np.float32(nodata_src)
    # the sentinel before any cast (NaN -> integer is undefined); int32
    # until the end: CUDA takes few operators on uint16 beyond copy
    q = torch.where(valid, q, float(nodata_u16)).to(torch.int32)
    return q.to(torch.uint16)


def quantize_u16(x: torch.Tensor, lo: Bound, hi: Bound,
                 valid: Optional[torch.Tensor] = None, nodata_u16: int = 0,
                 *, form: str = "stats", nodata_src: Optional[float] = None
                 ) -> torch.Tensor:
    """Quantize ``x`` to uint16 (see the module docstring). CUDA tensors
    go through the hand-written kernel, CPU tensors through
    :func:`quantize_u16_reference`. Returns x's shape as uint16."""
    if x.device.type == "cpu":
        return quantize_u16_reference(x, lo, hi, valid, nodata_u16,
                                      form=form, nodata_src=nodata_src)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    lo_t, p2 = _operands(x, lo, hi, form, valid)
    if not 0 <= int(nodata_u16) <= 65535:
        raise ValueError(f"nodata_u16 must be a u16 code, got {nodata_u16}")
    from ._build import load_library

    fn = load_library("quantize_u16").quantize_u16_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    xc = x.contiguous()
    mask = None if valid is None else valid.contiguous()
    lo_c, p2_c = lo_t.contiguous(), p2.contiguous()
    out = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(xc.data_ptr(), None if mask is None else mask.data_ptr(),
                lo_c.data_ptr(), p2_c.data_ptr(), int(lo_c.numel() > 1),
                out.data_ptr(), xc.numel(), x.shape[-1],
                FORMS.index(form), int(nodata_src is not None),
                0.0 if nodata_src is None else float(nodata_src),
                int(nodata_u16), stream)
    if rc != 0:
        raise RuntimeError(f"quantize_u16 kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(KERNEL_NAME)
    return out


def pallas_quantize_u16(x: torch.Tensor, lo: float, hi: float,
                        valid: Optional[torch.Tensor] = None,
                        nodata_u16: int = 0) -> torch.Tensor:
    """``pallas_quantize_u16`` (``pallas_ops.py:122``): x (N, C) float32
    with scalar ``lo``/``hi`` -> (N, C) uint16, in the pallas form. The
    TPU tiling arguments have no counterpart (nothing is padded)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (N, C), got {tuple(x.shape)}")
    return quantize_u16(x, lo, hi, valid, nodata_u16, form="pallas")
