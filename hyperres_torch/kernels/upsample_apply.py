"""The fused plan's 10 m apply as one kernel (``csrc/upsample_apply.cu``).

``upsample_apply(x60, valid60, spec_r, spec_c, coeffs)`` computes, in one
pass over the (Hd, Wd, 3) product, what phase 4 of
:func:`~hyperres_torch.fusion.fused._fusion_core` computes with eager
ops:

- the valid-mass-renormalised bilinear upsample of the stretched 60 m
  RGB ``x60`` (Hs, Ws, 3) under ``valid60`` (Hs, Ws), on the
  integer-aligned specs ``("bilin", f, r0s, ts, dst, src, cin_lo,
  cin_hi)`` of ``host.separable_fast_spec``
  (:func:`~hyperres_torch.kernels.warp.separable_resample_fast`);
- NaN in all three channels where any channel is not finite;
- the per-channel polynomial ``coeffs`` (3, deg + 1), highest power
  first, by Horner's rule (``lstsq.polyval_channels``; ``linear``'s
  (3, 2) ``a x + b`` is its degree-1 case);
- the clamp to [0, 1], NaN kept.

The kernel rounds every step as the eager ops do, so the two products
are equal bit for bit, NaN in the same places (``tests_gpu``). It takes
CUDA tensors only; the eager ops stay the plain version, and
:func:`takes_kernel` is the rule by which the plan chooses between them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import count_launch, launch_error

#: launch-counter name
KERNEL_NAME = "upsample_apply"
#: the plan's counter of launches inside its ``fused.apply`` span
APPLY_COUNTER = "apply.kernel"
#: the kernel's compile-time limits (``csrc/upsample_apply.cu``)
MAX_PHASES = 32
MAX_COEFFS = 16
CHANNELS = 3
_INDEX_LIMIT = 2 ** 31 - 1
#: fusion methods whose mapping is a per-channel polynomial
POLY_METHODS = ("ot_poly", "linear")


def _bilinear(spec) -> bool:
    """A bilinear spec the kernel takes: at most ``MAX_PHASES`` phases,
    and a first tap that advances by 0 or 1 from one destination index
    to the next (as the increasing index fields of
    ``separable_fast_spec`` give)."""
    if spec is None or spec[0] != "bilin" or not 1 <= spec[1] <= MAX_PHASES:
        return False
    f, r0 = spec[1], spec[2]
    if len(r0) != f:
        return False
    steps = [r0[i + 1] - r0[i] for i in range(f - 1)] + [r0[0] + 1 - r0[-1]]
    return all(s in (0, 1) for s in steps)


def takes_kernel(device, up_fast: Optional[tuple], fusion_method: str,
                 coeff_shape: Sequence[int]) -> bool:
    """Whether the plan's 10 m apply runs on the kernel: a CUDA device,
    integer-aligned bilinear specs on both axes that the kernel takes
    (``up_fast``; None is the dense route), a per-channel polynomial
    mapping (``ot_poly``, or ``linear``'s ``a x + b``) of 3 channels
    with at most ``MAX_COEFFS`` coefficients (``coeff_shape``), and a
    source and product of fewer than 2^31 floats. Everything else keeps
    the eager ops."""
    if torch.device(device).type != "cuda" or up_fast is None:
        return False
    if fusion_method not in POLY_METHODS:
        return False
    spec_r, spec_c = up_fast
    if not (_bilinear(spec_r) and _bilinear(spec_c)):
        return False
    if tuple(coeff_shape[:1]) != (CHANNELS,) or len(coeff_shape) != 2 \
            or not 1 <= coeff_shape[1] <= MAX_COEFFS:
        return False
    return (spec_r[4] * spec_c[4] * CHANNELS <= _INDEX_LIMIT
            and spec_r[5] * spec_c[5] * CHANNELS <= _INDEX_LIMIT)


def _axis(spec):
    """(f, r0 (f,) int32, w0 = f32(1 - t), w1 = t (f,) float32, cin_lo,
    cin_hi) of one axis, as ctypes arrays and numbers."""
    _, f, r0s, ts, _dst, _src, lo, hi = spec
    t = np.asarray(ts, np.float32)
    w0 = np.float32(1.0) - t
    return (int(f), (ctypes.c_int * f)(*[int(v) for v in r0s]),
            (ctypes.c_float * f)(*[float(v) for v in w0]),
            (ctypes.c_float * f)(*[float(v) for v in t]), int(lo), int(hi))


def upsample_apply(x60: torch.Tensor, valid60: torch.Tensor, spec_r,
                   spec_c, coeffs: torch.Tensor) -> torch.Tensor:
    """The 10 m product (``spec_r[4]``, ``spec_c[4]``, 3) of the kernel
    (module docstring): ``x60`` (Hs, Ws, 3) float32, ``valid60`` (Hs, Ws)
    bool and ``coeffs`` (3, n) float32, all contiguous on one CUDA
    device. Raises ``ValueError`` / ``TypeError`` for anything else.
    ``coeffs`` is read on the card: no host read, no synchronise."""
    for name, t in (("x60", x60), ("valid60", valid60), ("coeffs", coeffs)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the upsample-apply "
                             "kernel takes CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x60.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError(f"x60 and coeffs must be float32, got {x60.dtype} "
                        f"and {coeffs.dtype}")
    if valid60.dtype != torch.bool:
        raise TypeError(f"valid60 must be bool, got {valid60.dtype}")
    if x60.device != valid60.device or x60.device != coeffs.device:
        raise ValueError("x60, valid60 and coeffs must share a device")
    if x60.dim() != 3 or x60.shape[2] != CHANNELS \
            or tuple(valid60.shape) != tuple(x60.shape[:2]):
        raise ValueError(f"x60 must be (H, W, 3) and valid60 (H, W), got "
                         f"{tuple(x60.shape)} and {tuple(valid60.shape)}")
    if coeffs.dim() != 2 or coeffs.shape[0] != CHANNELS \
            or not 1 <= coeffs.shape[1] <= MAX_COEFFS:
        raise ValueError(f"coeffs must be (3, n), 1 <= n <= {MAX_COEFFS}, "
                         f"got {tuple(coeffs.shape)}")
    if not (_bilinear(spec_r) and _bilinear(spec_c)):
        raise ValueError("the kernel takes bilinear specs of at most "
                         f"{MAX_PHASES} phases whose first tap advances "
                         "by 0 or 1")
    hs, ws = x60.shape[:2]
    if (spec_r[5], spec_c[5]) != (hs, ws):
        raise ValueError(f"specs for a {spec_r[5]}x{spec_c[5]} source, "
                         f"x60 is {hs}x{ws}")
    hd, wd = int(spec_r[4]), int(spec_c[4])
    fr, r0r, w0r, w1r, rlo, rhi = _axis(spec_r)
    fc, r0c, w0c, w1c, clo, chi = _axis(spec_c)
    from ._build import load_library

    fn = load_library("upsample_apply").upsample_apply_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((hd, wd, CHANNELS), dtype=torch.float32,
                      device=x60.device)
    with torch.cuda.device(x60.device):
        stream = torch.cuda.current_stream(x60.device).cuda_stream
        rc = fn(x60.data_ptr(), valid60.data_ptr(), coeffs.data_ptr(),
                out.data_ptr(), hs, ws, hd, wd,
                fr, r0r, w0r, w1r, fc, r0c, w0c, w1c,
                rlo, rhi, clo, chi, int(coeffs.shape[1]), stream)
    if rc != 0:
        raise launch_error("upsample_apply kernel launch", rc)
    count_launch(KERNEL_NAME)
    return out
