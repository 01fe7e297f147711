"""Masked pixel sampling for the fusion fits
(``hyperres/fusion/sampling.py``).

- :func:`sample_valid_pixels_host` (``:20-36``): the reference's NumPy
  sampler, copied because the reference module imports jax. The same
  generator gives the same samples in both packages.
- :func:`sample_valid_pixels_device` (``:39``): Gumbel top-k, a uniform
  sample without replacement among the valid pixels, of a fixed size.
  The noise comes from an explicit ``torch.Generator`` (its stream
  differs from ``jax.random``'s, so tests inject the same NumPy noise
  into both packages through ``noise=``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def sample_valid_pixels_host(img: np.ndarray, mask: np.ndarray,
                             n_samples: int, seed: int = 0,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """(H, W, C) + (H, W) mask -> (ns, C) float64 sample, reference
    semantics: flatten masked pixels, drop non-finite rows, sample
    without replacement (color.py:80-95)."""
    rng = rng or np.random.default_rng(seed)
    X_all = img[mask].reshape(-1, img.shape[-1]).astype(np.float64)
    X_all = X_all[np.isfinite(X_all).all(axis=1)]
    if X_all.shape[0] == 0:
        return X_all
    ns = min(n_samples, X_all.shape[0])
    return X_all[rng.choice(X_all.shape[0], size=ns, replace=False)]


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
