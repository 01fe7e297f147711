"""The SR cell's data, made from the seed on the device: a frozen copy of
``scripts/torch_bench_sr_granule.py``'s ``training_data`` and
``granule_cube`` with a ``torch.Generator`` in place of NumPy's.

- A training set: X (n, bx) uniform in [0, 1); Y (n, by) =
  clip(0.15 + 0.5 X[:, 0] + 0.2 X[:, 1] + 0.05 U, 0.01, 0.99), U uniform:
  correlated bands as S2 and EMIT reflectances are.
- The footprint: (bx, h, w) uniform reflectances whose first
  ``h * w // 20`` pixels in row-major order are ``nodata`` in every band.
"""

from __future__ import annotations

import torch


def training_set(gen: torch.Generator, n: int, bx: int, by: int, device):
    X = torch.rand((n, bx), generator=gen, device=device)
    U = torch.rand((n, by), generator=gen, device=device)
    Y = torch.clamp(0.15 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2] + 0.05 * U,
                    0.01, 0.99)
    return X, Y


def footprint(gen: torch.Generator, bx: int, h: int, w: int, nodata: float,
              stripe_share: int, device) -> torch.Tensor:
    cube = torch.rand((bx, h, w), generator=gen, device=device)
    cube.view(bx, h * w)[:, :h * w // stripe_share] = nodata
    return cube
