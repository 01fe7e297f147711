"""Scanline resample: the kernel behind the two-pass warp.

``scanline_resample(src, pos, axis)`` computes one pass of the
Catmull-Smith scanline warp,

    out[p, q, c] = sum_s k(pos[p, q] - s) * src[..s..]

with ``k`` the cubic (a = -0.5) or bilinear profile and out-of-range
``s`` contributing zero:

- ``axis=1`` (pass 1): src (N, S, C), pos (N, D) -> (N, D, C);
- ``axis=0`` (pass 2): src (S, M, C), pos (D, M) -> (D, M, C), reading
  pass 1's natural layout (no transpose).

It replaces ``_banded_pass1``/``_banded_pass2`` behind
``pallas_banded_two_pass`` (``hyperres/kernels/pallas_ops.py:390-581``),
which compute the same thing for finite inputs (as does the dense twin
``_two_pass_core``, ``hyperres/kernels/warp.py:992``).

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/scanline_warp.cu`` (or raises); on a CPU tensor it runs
:func:`scanline_resample_reference`, the plain PyTorch version, which
evaluates the same at most four taps with ``torch.gather``.

``scanline_resample_dense(src (N, S, C), pos (N, D))`` is the dense
route, the counterpart of ``pallas_scanline_resample``
(``pallas_ops.py:189``) behind ``orthowarp_two_pass(backend="pallas")``:

    out[n, d, c] = sum_{s in [0, S)} k(pos[n, d] - s) * src[n, s, c]

and, with ``axis=0``, the same sum along axis 0 of a pass-2 ``src``
(S, M, C), which the reference computes on transposed copies. On a CUDA
tensor it makes the same launches as :func:`scanline_resample` (``k``
vanishes outside the kernel's four taps, so the kernel computes this
full-axis sum exactly for finite ``src``), counted under the dense
route's own name. Its plain version,
:func:`scanline_resample_dense_reference`, is the reference kernel's own
math: the weight rows ``W = k(pos - iota_S)`` times ``src``, in row
chunks. For a non-finite ``src`` the two differ: the dense product makes
the whole output row of that channel non-finite (0 * NaN), the taps only
the outputs that read it. Precision ``"high"`` and ``"highest"`` both
compute exact f32; ``"default"`` (1-pass bf16) is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_launch, launch_error
from .host import cubic_kernel_weight

#: launch-counter names, by contraction axis
KERNEL_NAMES = {1: "scanline_resample_pass1", 0: "scanline_resample_pass2"}
#: launch-counter name of the dense route
DENSE_KERNEL_NAME = "scanline_resample_dense"
_METHODS = ("cubic", "bilinear")
#: largest weight block (elements) of the dense plain version
_DENSE_W_ELEMS = 1 << 26


def _profile(dist: torch.Tensor, method: str) -> torch.Tensor:
    if method == "bilinear":
        return torch.clamp(1.0 - dist.abs(), min=0.0)
    return cubic_kernel_weight(dist, xp=torch)


def _check(src: torch.Tensor, pos: torch.Tensor, axis: int, method: str):
    """Validate the operands; returns (P, Q, C, S) of the contraction."""
    if method not in _METHODS:
        raise ValueError(f"Unknown method {method!r}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if src.dim() != 3 or pos.dim() != 2:
        raise ValueError(f"src must be 3-D and pos 2-D, got "
                         f"{tuple(src.shape)} and {tuple(pos.shape)}")
    if src.dtype != torch.float32 or pos.dtype != torch.float32:
        raise TypeError(f"src and pos must be float32, got {src.dtype} "
                        f"and {pos.dtype}")
    if src.device != pos.device:
        raise ValueError(f"src on {src.device} but pos on {pos.device}")
    if axis == 1:
        p, s, c = src.shape
        q = pos.shape[1]
        if pos.shape[0] != p:
            raise ValueError(f"pass 1: pos rows {pos.shape[0]} != src "
                             f"rows {p}")
    else:
        s, q, c = src.shape
        p = pos.shape[0]
        if pos.shape[1] != q:
            raise ValueError(f"pass 2: pos columns {pos.shape[1]} != src "
                             f"columns {q}")
    return p, q, c, s


def scanline_resample_reference(src: torch.Tensor, pos: torch.Tensor,
                                 axis: int, method: str = "cubic"
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same <= 4 taps at
    s = floor(pos) - 1 ... floor(pos) + 2, gathered and summed in tap
    order. Materialises one gathered (P, Q, C) tap at a time."""
    p, q, c, s = _check(src, pos, axis, method)
    # a tap can land in [0, S) only for -2 <= pos < S + 1 (also rejects
    # NaN and the +-1e6 padding positions)
    live = (pos >= -2.0) & (pos < s + 1.0)
    base = torch.floor(torch.where(live, pos, torch.zeros_like(pos)))
    base = base.to(torch.int64)
    out = torch.zeros((p, q, c), dtype=torch.float32, device=src.device)
    for t in range(4):
        si = base + (t - 1)
        ok = live & (si >= 0) & (si < s)
        w = torch.where(ok, _profile(pos - si.to(torch.float32), method),
                        torch.zeros_like(pos))
        idx = si.clamp(0, s - 1)[..., None].expand(p, q, c)
        vals = torch.gather(src, axis, idx)
        out += torch.where(ok[..., None], w[..., None] * vals,
                           torch.zeros((), device=src.device))
    return out


def _launch(src: torch.Tensor, pos: torch.Tensor, axis: int,
            method: str, name: str) -> torch.Tensor:
    """Launch ``csrc/scanline_warp.cu`` for one pass over CUDA tensors:
    ``src`` is read through its own strides (unit channel stride), the
    (P, Q, C) result is contiguous. Counts one launch of ``name``."""
    p, q, c, s = _check(src, pos, axis, method)
    if src.device.type != "cuda":
        raise ValueError(f"no scanline kernel for device {src.device}")
    if src.stride(2) != 1 or not pos.is_contiguous():
        raise ValueError("the scanline kernel needs a unit channel stride "
                         "in src and a contiguous pos")
    from ._build import load_library

    lib = load_library("scanline_warp")
    fn = lib.scanline_resample_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if axis == 1:
        sp, sq, ss = src.stride(0), 0, src.stride(1)
    else:
        sp, sq, ss = 0, src.stride(1), src.stride(0)
    out = torch.empty((p, q, c), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), pos.data_ptr(), out.data_ptr(), p, q, c, s,
                sp, sq, ss, int(method == "cubic"), stream)
    if rc != 0:
        raise launch_error("scanline_resample kernel launch", rc)
    count_launch(name)
    return out


def scanline_resample(src: torch.Tensor, pos: torch.Tensor, axis: int,
                      method: str = "cubic") -> torch.Tensor:
    """One scanline-resample pass (see the module docstring). CUDA
    tensors go through the hand-written kernel, CPU tensors through
    :func:`scanline_resample_reference`."""
    if src.device.type == "cpu":
        return scanline_resample_reference(src, pos, axis, method)
    return _launch(src, pos, axis, method, KERNEL_NAMES[axis])


def check_precision(precision: str) -> None:
    """The ported precisions: ``"high"`` and ``"highest"``, both exact
    f32. ``"default"`` (1-pass bf16) is not ported."""
    if precision == "default":
        raise NotImplementedError(
            "precision 'default' (1-pass bf16) is not ported; 'high' and "
            "'highest' both compute exact f32")
    if precision not in ("high", "highest"):
        raise ValueError(f"Unknown precision {precision!r}")


def scanline_resample_dense_reference(src: torch.Tensor, pos: torch.Tensor,
                                      method: str = "cubic",
                                      precision: str = "high",
                                      axis: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the dense route: per source row the
    weight matrix ``W = k(pos[n, :, None] - iota_S)`` (D, S) times
    ``src[n]`` (S, C), in f32, for as many rows at a time as keep a
    weight block under 2**26 elements. ``axis=0`` computes the same on
    contiguous transposed copies, as the reference warp does, and
    returns the contiguous (D, M, C) result."""
    _check(src, pos, axis, method)
    check_precision(precision)
    if axis == 0:
        return scanline_resample_dense_reference(
            src.transpose(0, 1).contiguous(), pos.T, method, precision
        ).transpose(0, 1).contiguous()
    n, s = src.shape[:2]
    d = pos.shape[1]
    out = torch.empty((n, d, src.shape[2]), dtype=torch.float32,
                      device=src.device)
    iota = torch.arange(s, dtype=torch.float32, device=src.device)
    rows = max(1, _DENSE_W_ELEMS // max(1, d * s))
    for i in range(0, n, rows):
        W = _profile(pos[i:i + rows, :, None] - iota, method)
        out[i:i + rows] = torch.bmm(W, src[i:i + rows])
    return out


def scanline_resample_dense(src: torch.Tensor, pos: torch.Tensor,
                            method: str = "cubic", precision: str = "high",
                            axis: int = 1) -> torch.Tensor:
    """The dense scanline resample (see the module docstring): src
    (N, S, C), pos (N, D) -> (N, D, C), or with ``axis=0`` src (S, M, C),
    pos (D, M) -> (D, M, C). CUDA tensors go through the hand-written
    kernel (``src`` through its strides, unit channel stride), CPU
    tensors through :func:`scanline_resample_dense_reference`."""
    check_precision(precision)
    if src.device.type == "cpu":
        return scanline_resample_dense_reference(src, pos, method,
                                                 precision, axis)
    return _launch(src, pos, axis, method, DENSE_KERNEL_NAME)
