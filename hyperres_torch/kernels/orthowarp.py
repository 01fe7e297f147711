"""The fused GLT + two-pass ortho warp as two kernels
(``csrc/scanline_warp.cu``).

``orthowarp(raw, glt_flat_idx, glt_valid, rows, cols, cstar, ...)``
computes what :func:`~hyperres_torch.kernels.warp.orthowarp_two_pass`'s
plain chain computes (``orthowarp_src_ext``, two ``scanline_resample``
passes, ``_renormalise``) in two launches:

- pass 1 (:func:`pass1`) reads the raw (H, W, B) cube in place through
  the GLT: channel c < B of ortho sample (p, s) is
  ``raw[flat[p, s], c] * valid[p, s]`` (the eager product's rounding,
  so a non-finite raw value under an invalid GLT cell poisons what it
  poisons there), channel B is ``valid[p, s]``; out the (Ho, Wd, B + 1)
  intermediate, the plain chain's pass-1 output bit for bit;
- pass 2 (:func:`pass2`) contracts the intermediate along the ortho rows
  at ``rows`` and, per destination, divides each band by the validity
  channel's sum where that sum's magnitude exceeds 1e-6 and the centre
  lies inside the source, else writes ``fill``; out the (Hd, Wd, B)
  result.

Each tap is one fused multiply-add in tap order from 0 and the division
is IEEE, as the plain chain computes them on the card, so the result
equals it bit for bit (``tests_gpu``). The kernels take CUDA tensors
only; the plain chain stays what the CPU runs, and :func:`takes_kernel`
is the rule by which ``orthowarp_two_pass`` chooses between them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.constants import NO_DATA_VALUE
from ..device import count_launch, launch_error

#: launch-counter names, by pass
KERNEL_NAMES = {1: "orthowarp_pass1", 2: "orthowarp_pass2"}
#: ``orthowarp_two_pass``'s counter of fused warps inside the caller's open
#: span (``fused.warp``, ``ortho.data`` / ``ortho.loc`` / ``ortho.obs``)
ORTHOWARP_COUNTER = "orthowarp.kernel"
METHODS = ("cubic", "bilinear")


def takes_kernel(device, backend: str) -> bool:
    """Whether ``orthowarp_two_pass`` on ``device`` with ``backend`` runs
    on the two kernels: a CUDA device and the banded route (``"auto"``,
    ``"xla"``, ``"pallas_banded"``). The CPU, and the dense route
    (``"pallas"``), keep the chain of scanline passes."""
    return torch.device(device).type == "cuda" and backend != "pallas"


def _need(t: torch.Tensor, name: str, shape, dev, dtypes=(torch.float32,)):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, raw on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"tensors on {dev}: the ortho warp kernels take "
                         "CUDA tensors only")


def _method(method: str) -> int:
    if method not in METHODS:
        raise ValueError(f"the kernels take {METHODS}, got {method!r}")
    return int(method == "cubic")


def pass1(raw: torch.Tensor, glt_flat_idx: torch.Tensor,
          valid_f: torch.Tensor, cstar: torch.Tensor,
          method: str = "cubic") -> torch.Tensor:
    """Pass 1 (module docstring): raw (H, W, B) float32 with a unit
    channel stride and its pixels at one stride (a contiguous cube, or a
    band slice of one); ``glt_flat_idx`` (Ho, Wo) int32 or int64, every
    index in [0, H * W) as ``prepare_glt`` makes them; ``valid_f`` (Ho,
    Wo) float32; ``cstar`` (Ho, Wd) float32; all contiguous on one CUDA
    device. Returns the (Ho, Wd, B + 1) intermediate."""
    cubic = _method(method)
    if raw.dim() != 3:
        raise ValueError(f"raw must be (H, W, B), got {tuple(raw.shape)}")
    if raw.dtype != torch.float32:
        raise TypeError(f"raw must be float32, got {raw.dtype}")
    h, w, b = raw.shape
    if raw.stride(2) != 1 or raw.stride(0) != w * raw.stride(1):
        raise ValueError("raw needs a unit channel stride and its pixels at "
                         "one stride")
    dev = raw.device
    if glt_flat_idx.dim() != 2:
        raise ValueError(f"glt_flat_idx must be (Ho, Wo), got "
                         f"{tuple(glt_flat_idx.shape)}")
    ho, wo = glt_flat_idx.shape
    _need(glt_flat_idx, "glt_flat_idx", (ho, wo), dev,
          (torch.int32, torch.int64))
    _need(valid_f, "valid_f", (ho, wo), dev)
    if cstar.dim() != 2 or cstar.shape[0] != ho:
        raise ValueError(f"cstar must be ({ho}, Wd), got "
                         f"{tuple(cstar.shape)}")
    _need(cstar, "cstar", cstar.shape, dev)
    _cuda(dev)
    wd = cstar.shape[1]
    from ._build import load_library

    fn = load_library("scanline_warp").orthowarp_pass1_f32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((ho, wd, b + 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(raw.data_ptr(), raw.stride(1), glt_flat_idx.data_ptr(),
                int(glt_flat_idx.dtype == torch.int64), valid_f.data_ptr(),
                cstar.data_ptr(), out.data_ptr(), ho, wo, wd, b, cubic,
                stream)
    if rc != 0:
        raise launch_error("orthowarp_pass1 kernel launch", rc)
    count_launch(KERNEL_NAMES[1])
    return out


def pass2(mid: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
          wo: int, method: str = "cubic",
          fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """Pass 2 with the renormalisation (module docstring): ``mid`` the
    (Ho, Wd, B + 1) intermediate of :func:`pass1`; ``rows`` / ``cols``
    (Hd, Wd) float32, the destination centres' fractional indices in the
    Ho x ``wo`` ortho grid; all contiguous on one CUDA device. Returns
    the (Hd, Wd, B) result."""
    cubic = _method(method)
    if mid.dim() != 3 or mid.shape[-1] < 1:
        raise ValueError(f"mid must be (Ho, Wd, B + 1), got "
                         f"{tuple(mid.shape)}")
    ho, wd, c = mid.shape
    dev = mid.device
    _need(mid, "mid", mid.shape, dev)
    if rows.dim() != 2 or rows.shape[1] != wd:
        raise ValueError(f"rows must be (Hd, {wd}), got {tuple(rows.shape)}")
    _need(rows, "rows", rows.shape, dev)
    _need(cols, "cols", rows.shape, dev)
    _cuda(dev)
    hd = rows.shape[0]
    from ._build import load_library

    fn = load_library("scanline_warp").orthowarp_pass2_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((hd, wd, c - 1), dtype=torch.float32, device=dev)
    # the centre test's bounds as the eager comparison casts them
    row_hi, col_hi = (float(np.float32(n - 0.5)) for n in (ho, wo))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(mid.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                out.data_ptr(), hd, wd, ho, c - 1, row_hi, col_hi,
                float(np.float32(fill)), cubic, stream)
    if rc != 0:
        raise launch_error("orthowarp_pass2 kernel launch", rc)
    count_launch(KERNEL_NAMES[2])
    return out


def orthowarp(raw: torch.Tensor, glt_flat_idx: torch.Tensor,
              glt_valid: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, cstar: torch.Tensor,
              method: str = "cubic",
              fill: float = NO_DATA_VALUE) -> torch.Tensor:
    """The (Hd, Wd, B) warp of :func:`pass1` then :func:`pass2`, with
    ``glt_valid`` (Ho, Wo) of any dtype taken as ``.to(float32)`` (the
    plain chain's validity channel). Raises ``ValueError`` /
    ``TypeError`` for operands the kernels do not take."""
    if glt_valid.device != raw.device:
        raise ValueError(f"glt_valid on {glt_valid.device}, raw on "
                         f"{raw.device}")
    valid_f = glt_valid.to(torch.float32).contiguous()
    mid = pass1(raw, glt_flat_idx, valid_f, cstar, method)
    return pass2(mid, rows, cols, glt_flat_idx.shape[1], method, fill)
