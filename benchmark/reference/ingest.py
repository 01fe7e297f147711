"""Plain reference of the raw cube as the default ingest leaves it on the
device, in PyTorch: per band, an affine uint16 code over the band's valid
range (finite and not nodata), ``q = clip(rint((x - min) * (1 / s)), 0,
65534)`` with ``s = (max - min) / 65534`` (1 where that is not above 0),
all in float32 with one rounding per operation, 65535 where the value
is not valid, and back ``q * s + min`` in float32, nodata at 65535. A ``"f32"`` transfer is the
cube itself."""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 65535


def roundtrip(raw: np.ndarray, transfer: str, device, nodata: float = -9999.0,
              block: int = 32) -> torch.Tensor:
    """The (H, W, B) float32 cube after ``transfer`` ("u16" or "f32") on
    ``device``, ``block`` bands at a time."""
    x_all = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
    if transfer == "f32":
        return x_all
    if transfer != "u16":
        raise ValueError(f"no reference for transfer {transfer!r}")
    nod = float(np.float32(nodata))
    out = torch.empty_like(x_all)
    for b0 in range(0, x_all.shape[-1], block):
        x = x_all[..., b0:b0 + block]
        valid = torch.isfinite(x) & (x != nod)
        lo = torch.where(valid, x, torch.inf).amin(dim=(0, 1)).cpu().numpy()
        hi = torch.where(valid, x, -torch.inf).amax(dim=(0, 1)).cpu().numpy()
        # the per-band affine in NumPy float32 on the host, where division
        # is rounded once (a CUDA division by a scalar is a product with
        # its reciprocal)
        dead = ~np.isfinite(lo)
        lo[dead] = 0.0
        hi[dead] = 0.0
        s = (hi - lo) / np.float32(SENTINEL - 1)
        s[s <= 0.0] = 1.0
        r = np.float32(1.0) / s
        lo_t, s_t, r_t = (torch.from_numpy(a).to(x.device) for a in (lo, s, r))
        q = torch.clamp(torch.round((x - lo_t) * r_t), 0, SENTINEL - 1)
        out[..., b0:b0 + block] = torch.where(valid, q * s_t + lo_t, nod)
    del x_all
    return out
