"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference computes from the same inputs,
each held to a limit stated in the configuration's file."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch


@dataclass
class Check:
    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return self.limit is not None and self.value == self.value \
            and self.value <= self.limit


def max_gap(got: torch.Tensor, want: torch.Tensor, fill=None,
            weight: Optional[torch.Tensor] = None,
            block: int = 1 << 22) -> Dict[str, float]:
    """Over two (H, W, ...) tensors of one shape: ``gap``, the largest
    |got - want| (times ``weight`` (H, W), where given) where both hold a
    value (finite and not ``fill``), and ``mask``, the count of elements
    where exactly one does. In blocks of rows, on ``want``'s device."""
    h = want.shape[0]
    rows = max(1, block // max(1, want[0].numel()))
    gap, mask = 0.0, 0
    for s in range(0, h, rows):
        gb = got[s:s + rows].to(want.device, torch.float32)
        wb = want[s:s + rows].to(torch.float32)
        hg, hw = torch.isfinite(gb), torch.isfinite(wb)
        if fill is not None:
            hg &= gb != fill
            hw &= wb != fill
        both = hg & hw
        mask += int((hg != hw).sum())
        d = (gb - wb).abs()
        if weight is not None:
            wt = weight[s:s + rows].to(torch.float32)
            d = d * wt.reshape(wt.shape + (1,) * (d.dim() - wt.dim()))
        if bool(both.any()):
            gap = max(gap, float(d[both].max()))
    return {"gap": gap, "mask": float(mask)}


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Per name, the largest reading over several compared requests."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    return [Check(k, float(v), limits.get(k)) for k, v in readings.items()]
