"""Histogram matching (CDF transfer), s2_emit/color.py:36-63
(``hyperres/fusion/histogram.py``).

Per channel: sort the masked reference values, and map each masked
source value through its empirical CDF rank into the reference quantile
function. Shapes are fixed: a masked-out value sorts as ``+inf``, behind
every valid one.

The reference may have another shape and mask than the source (a 10 m
source matched against the 60 m stretched reference distribution the
fit used keeps the normalisation consistent across resolutions).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def _match_channel_device(src: torch.Tensor, src_mask: torch.Tensor,
                          ref: torch.Tensor, ref_mask: torch.Tensor
                          ) -> torch.Tensor:
    """(H, W) channel histogram match within masks (``histogram.py:19``).
    Masked-out source pixels pass through unchanged (color.py:49-53).
    With an empty reference mask every masked source pixel reads
    position 0 of an all-``inf`` array and comes out NaN, as in the
    reference."""
    flat_src = src.reshape(-1)
    flat_ref = ref.reshape(-1)
    flat_sm = src_mask.reshape(-1)
    flat_rm = ref_mask.reshape(-1)
    n_src = flat_sm.sum()
    n_ref = flat_rm.sum()
    inf = torch.tensor(float("inf"), device=src.device)

    # reference quantile function: the sorted valid values (invalid ->
    # +inf at the tail, never indexed: positions stay < n_ref)
    ref_sorted = torch.sort(torch.where(flat_rm, flat_ref, inf)).values

    # CDF rank of each source pixel among the valid source values
    src_sorted = torch.sort(torch.where(flat_sm, flat_src, inf)).values
    ranks = torch.searchsorted(src_sorted, flat_src.contiguous(), right=True)
    del src_sorted
    quant = ranks.to(torch.float32) / n_src.clamp(min=1).to(torch.float32)
    del ranks

    # interpolate into the reference quantile function
    pos = quant * (n_ref.to(torch.float32) - 1.0)
    top = (n_ref - 1).clamp(min=0)
    lo = torch.minimum(torch.floor(pos).to(torch.int64).clamp(min=0), top)
    hi = torch.minimum(lo + 1, top)
    t = pos - lo.to(torch.float32)
    matched = (1.0 - t) * ref_sorted[lo] + t * ref_sorted[hi]
    return torch.where(flat_sm, matched, flat_src).reshape(src.shape)


def _match_rgb_device(src_rgb: torch.Tensor, src_mask: torch.Tensor,
                      ref_rgb: torch.Tensor, ref_mask: torch.Tensor
                      ) -> torch.Tensor:
    """Channel-wise :func:`_match_channel_device`, clipped to [0, 1]
    (``histogram.py:54``)."""
    chans = [_match_channel_device(src_rgb[..., c], src_mask,
                                   ref_rgb[..., c], ref_mask)
             for c in range(src_rgb.shape[-1])]
    return torch.clamp(torch.stack(chans, dim=-1), 0.0, 1.0)


def histogram_match_rgb(src_rgb: np.ndarray, ref_rgb: np.ndarray,
                        mask: np.ndarray,
                        ref_mask: Optional[np.ndarray] = None,
                        device=None) -> np.ndarray:
    """Channel-wise histogram matching within ``mask``, clipped to
    [0, 1] (color.py:55-63, ``histogram.py:64``). Inputs (H, W, C) in
    [0, 1], NumPy in and out. ``ref_mask`` lets the reference
    distribution come from another raster and mask than the source (by
    default the shared ``mask``). ``device``: default the current CUDA
    device."""
    dev = resolve_device(device)
    if ref_mask is None:
        ref_mask = mask

    def f32(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    def b(x):
        return torch.from_numpy(np.asarray(x, dtype=bool)).to(dev)

    return _match_rgb_device(f32(src_rgb), b(mask), f32(ref_rgb),
                             b(ref_mask)).cpu().numpy()
