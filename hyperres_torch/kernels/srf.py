"""SRF band synthesis as one band-mixing matmul (``hyperres/kernels/srf.py:108``).

Both trapezoid integrals of the reference are linear in the spectrum,
so the synthesis is ``(H*W, B) @ (B, S)`` with the host-built weight
matrix (``kernels.host.build_srf_weight_matrix``). The reference leaves
this product to XLA outside any Pallas kernel; here it is a plain f32
``torch.matmul`` (TF32 off, :mod:`hyperres_torch.device`).
"""

from __future__ import annotations

from typing import Optional

import torch

from hyperres.core.constants import NO_DATA_VALUE


def srf_synthesize(cube_hwb: torch.Tensor, weights_bs: torch.Tensor,
                   valid_mask: Optional[torch.Tensor] = None,
                   fill_value: float = NO_DATA_VALUE) -> torch.Tensor:
    """(H, W, B) x (B, S) -> (H, W, S). ``valid_mask`` (H, W) optionally
    sets nodata pixels to ``fill_value``."""
    h, w, b = cube_hwb.shape
    out = torch.matmul(cube_hwb.reshape(-1, b), weights_bs)
    out = out.reshape(h, w, weights_bs.shape[1])
    if valid_mask is not None:
        out = out.masked_fill(~valid_mask[..., None], fill_value)
    return out
