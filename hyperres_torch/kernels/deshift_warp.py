"""The coregistration's deshift as one kernel (``csrc/deshift_warp.cu``).

``deshift_warp(stack, affine, ...)`` computes, in one pass from the
(B, H, W) stack in its own dtype to the (B, H, W) product, what the eager
chain of :func:`~hyperres_torch.coreg.local.deshift_hwb` and the cast
after it compute:

- the sampling positions (r + dy, c + dx): the affine evaluated in
  float64 and rounded to float32 (``coreg.local._shift_field_device``),
  or, with local residuals, the float32 (H, W) fields ``dy`` / ``dx``
  that the caller made with ``shift_field``;
- the nodata-renormalised cubic or bilinear gather of
  :func:`~hyperres_torch.kernels.warp.warp_interpolate`, a band's taps
  excluded where they are ``nodata`` or not finite (with a nodata
  value), ``fill`` where the mass fails or the centre lies outside;
- for a u16 product, the cast as the reference writes it: NaN to
  ``nodata`` (0 without one), clipped to [0, 65535], truncated.

The kernel rounds every step as the eager ops do on the card, so the two
products are equal bit for bit (``tests_gpu``). It takes CUDA tensors
only; the eager chain stays the plain version, and :func:`takes_kernel`
is the rule by which the deshift chooses between them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..device import count_launch, launch_error

#: launch-counter name
KERNEL_NAME = "deshift_warp"
#: the coregistration's counter of launches inside its ``coreg.deshift``
#: span
DESHIFT_COUNTER = "deshift.kernel"
#: the stack dtypes the kernel reads, the products it writes, its methods
DTYPES = (torch.uint16, torch.float32)
METHODS = ("cubic", "bilinear")
#: the kernel's limit on H and W (r and c exact in float32)
MAX_SIDE = 2 ** 24


def takes_kernel(device, dtype: torch.dtype, method: str) -> bool:
    """Whether the deshift of a stack of ``dtype`` on ``device`` with
    ``method`` runs on the kernel: a CUDA device, a uint16 or float32
    stack, cubic or bilinear. Everything else (the CPU, another dtype,
    ``nearest``) keeps the eager chain."""
    return (torch.device(device).type == "cuda" and dtype in DTYPES
            and method in METHODS)


def deshift_warp(stack: torch.Tensor, affine, out_dtype: torch.dtype, *,
                 dy: Optional[torch.Tensor] = None,
                 dx: Optional[torch.Tensor] = None,
                 nodata: Optional[float] = None,
                 method: str = "cubic") -> torch.Tensor:
    """The (B, H, W) product in ``out_dtype`` (uint16 or float32) of the
    kernel (module docstring): ``stack`` (B, H, W) uint16 or float32,
    contiguous on a CUDA device; ``affine`` the (2, 3) shift model,
    rows (dy, dx); ``dy`` / ``dx`` the float32 (H, W) shift fields that
    replace the affine, contiguous on the stack's device, or both None.
    Raises ``ValueError`` / ``TypeError`` for anything else."""
    if stack.device.type != "cuda":
        raise ValueError(f"stack on {stack.device}: the deshift kernel "
                         "takes CUDA tensors only")
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous")
    if stack.dtype not in DTYPES:
        raise TypeError(f"stack must be uint16 or float32, got {stack.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"the product must be uint16 or float32, got "
                        f"{out_dtype}")
    if method not in METHODS:
        raise ValueError(f"the kernel takes {METHODS}, got {method!r}")
    if stack.dim() != 3:
        raise ValueError(f"stack must be (B, H, W), got {tuple(stack.shape)}")
    b, h, w = stack.shape
    if h >= MAX_SIDE or w >= MAX_SIDE:
        raise ValueError(f"H and W must be below {MAX_SIDE}, got {h}x{w}")
    if (dy is None) != (dx is None):
        raise ValueError("give both shift fields or neither")
    if dy is not None:
        for name, t in (("dy", dy), ("dx", dx)):
            if (t.device != stack.device or t.dtype != torch.float32
                    or tuple(t.shape) != (h, w) or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"({h}, {w}) tensor on {stack.device}")
    a = np.asarray(affine, dtype=np.float64)
    if a.shape != (2, 3):
        raise ValueError(f"affine must be (2, 3), got {a.shape}")
    # the eager chain's fill and NaN code: nodata in float32, else NaN / 0
    nd = None if nodata is None else float(np.float32(nodata))
    from ._build import load_library

    fn = load_library("deshift_warp").deshift_warp
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    coeffs = (ctypes.c_double * 6)(*a.reshape(-1).tolist())
    out = torch.empty((b, h, w), dtype=out_dtype, device=stack.device)
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        rc = fn(stack.data_ptr(), int(stack.dtype == torch.uint16),
                out.data_ptr(), int(out_dtype == torch.uint16), b, h, w,
                coeffs, None if dy is None else dy.data_ptr(),
                None if dx is None else dx.data_ptr(),
                int(method == "cubic"), int(nd is not None), nd or 0.0,
                np.nan if nd is None else nd, nd or 0.0, stream)
    if rc != 0:
        raise launch_error("deshift_warp kernel launch", rc)
    count_launch(KERNEL_NAME)
    return out
