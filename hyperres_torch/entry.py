"""The flagship model's forward step, as ``__graft_entry__.entry`` gives
it for the JAX package: the ridge spectral-SR model fitted (degree 3)
from 10 S2 bands to the 285 EMIT bands on seeded synthetic pixels, and
one batch of 8192 pixels to run it on.

    forward, (x,) = entry("cuda")
    y = forward(x)            # (8192, 285) reflectance in [0, 1]
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from .core.config import RidgeSRConfig
from .core.constants import EMIT_BANDS

from .fusion.ridge_sr import RidgeSpectralSR

N_IN = 10


def entry_data() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The training pixels X (4096, 10), Y (4096, 285) and the forward
    batch (8192, 10), all f32, drawn as ``__graft_entry__.entry`` draws
    them (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    X = rng.random((4096, N_IN)).astype(np.float32)
    Y = np.clip(0.2 + 0.4 * X[:, :1] + 0.05 * rng.random((4096, EMIT_BANDS)),
                0.01, 0.99).astype(np.float32)
    x = rng.random((8192, N_IN)).astype(np.float32)
    return X, Y, x


def entry(device: Union[str, torch.device, None] = None
          ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                     Tuple[torch.Tensor]]:
    """(forward, example_args): the fitted model (its call is the
    forward: standardise -> cubic monomial expansion -> ridge matmul ->
    sigmoid) and the (8192, 10) batch, both on ``device`` (by default the
    current CUDA device; ``"cpu"`` for the CPU)."""
    X, Y, x = entry_data()
    model = RidgeSpectralSR(N_IN, EMIT_BANDS, RidgeSRConfig(degree=3),
                            device=device).fit(X, Y)
    return model, (torch.from_numpy(x).to(model.device),)
