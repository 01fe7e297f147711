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
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_launch
from .host import cubic_kernel_weight

#: launch-counter names, by contraction axis
KERNEL_NAMES = {1: "scanline_resample_pass1", 0: "scanline_resample_pass2"}
_METHODS = ("cubic", "bilinear")


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


def scanline_resample(src: torch.Tensor, pos: torch.Tensor, axis: int,
                      method: str = "cubic") -> torch.Tensor:
    """One scanline-resample pass (see the module docstring). CUDA
    tensors go through the hand-written kernel, CPU tensors through
    :func:`scanline_resample_reference`."""
    p, q, c, s = _check(src, pos, axis, method)
    if src.device.type == "cpu":
        return scanline_resample_reference(src, pos, axis, method)
    if src.device.type != "cuda":
        raise ValueError(f"no scanline kernel for device {src.device}")
    if not (src.is_contiguous() and pos.is_contiguous()):
        raise ValueError("scanline_resample needs contiguous src and pos")
    from ._build import load_library

    lib = load_library("scanline_warp")
    fn = lib.scanline_resample_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if axis == 1:
        sp, sq, ss = s * c, 0, c
    else:
        sp, sq, ss = 0, c, q * c
    out = torch.empty((p, q, c), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), pos.data_ptr(), out.data_ptr(), p, q, c, s,
                sp, sq, ss, int(method == "cubic"), stream)
    if rc != 0:
        raise RuntimeError(f"scanline_resample kernel launch failed: CUDA "
                           f"error {rc}")
    count_launch(KERNEL_NAMES[axis])
    return out
