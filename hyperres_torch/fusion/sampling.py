"""Fixed-shape masked pixel sampling for the fusion fit
(``hyperres/fusion/sampling.py:39``).

Gumbel top-k: a uniform sample without replacement among the valid
pixels, of a fixed size. The noise comes from an explicit
``torch.Generator`` (its stream differs from ``jax.random``'s, so tests
inject the same NumPy noise into both packages through ``noise=``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gumbel_noise(n: int, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """(n,) standard Gumbel samples, -log(-log(U)), U in [tiny, 1)."""
    u = torch.rand(n, generator=generator, device=device,
                   dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_valid_pixels_device(img: torch.Tensor, mask: torch.Tensor,
                               n_samples: int,
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, C) + mask (H, W) -> (sample (n, C), weights (n,)) with
    n = min(n_samples, H*W). Weights are 0 for slots beyond the number
    of valid (masked and finite) pixels. ``noise`` (H*W,) replaces the
    Gumbel draw from ``generator`` (one of the two is required)."""
    c = img.shape[-1]
    flat = img.reshape(-1, c)
    n_samples = min(int(n_samples), flat.shape[0])
    valid = mask.reshape(-1) & torch.isfinite(flat).all(dim=-1)
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or injected noise")
        noise = gumbel_noise(flat.shape[0], generator, img.device)
    score = torch.where(valid, noise.to(torch.float32),
                        torch.tensor(float("-inf"), device=img.device))
    idx = torch.topk(score, n_samples).indices
    take = flat[idx]
    n_valid = valid.sum()
    w = valid[idx].to(torch.float32)
    w = w * (torch.arange(n_samples, device=img.device) < n_valid)
    return take, w
