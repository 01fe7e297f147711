"""GLT orthorectification gather (``hyperres/kernels/glt.py:45-63``).

One ``index_select`` along the flattened raw-pixel axis of the
``(H*W, B)`` cube: the spectral axis stays minor, so each gathered row
is a contiguous B-float read. The host precompute (``prepare_glt``) is
the port-owned copy in :mod:`hyperres_torch.kernels.host`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import NO_DATA_VALUE
from ..device import resolve_device
from .host import prepare_glt


def glt_take(raw_hwb: torch.Tensor, flat_idx: torch.Tensor
             ) -> torch.Tensor:
    """raw (raw_h, raw_w, B) gathered at flat_idx (H, W) -> (H, W, B),
    with no nodata fill (invalid GLT entries gather raw pixel 0)."""
    b = raw_hwb.shape[-1]
    gathered = torch.index_select(raw_hwb.reshape(-1, b), 0,
                                  flat_idx.reshape(-1).long())
    return gathered.reshape(*flat_idx.shape, b)


def glt_gather(raw_hwb: torch.Tensor, flat_idx: torch.Tensor,
               valid: torch.Tensor,
               fill_value: float = NO_DATA_VALUE) -> torch.Tensor:
    """raw (raw_h, raw_w, B) + flat_idx/valid (H, W) -> ortho (H, W, B),
    ``fill_value`` where the GLT has no source pixel."""
    return torch.where(valid[..., None], glt_take(raw_hwb, flat_idx),
                       torch.tensor(fill_value, dtype=raw_hwb.dtype,
                                    device=raw_hwb.device))


def orthorectify(raw_hwb, glt, fill_value: float = NO_DATA_VALUE,
                 device=None) -> torch.Tensor:
    """Reference-semantics ortho in one call (``glt.py:57``): the host
    GLT precompute, then :func:`glt_gather` on ``device`` (default the
    current CUDA device). ``raw_hwb`` is a NumPy array or a tensor."""
    dev = resolve_device(device)
    flat, valid = prepare_glt(np.asarray(glt),
                              (raw_hwb.shape[0], raw_hwb.shape[1]))
    return glt_gather(torch.as_tensor(raw_hwb).to(dev),
                      torch.from_numpy(flat).to(dev),
                      torch.from_numpy(valid).to(dev),
                      fill_value=fill_value)
