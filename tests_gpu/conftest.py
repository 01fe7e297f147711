"""The port's card-side tests: each kernel against its plain PyTorch
version, the torch demos, and under ``fullscale/`` every main path at its
real size. They import only ``torch``, ``numpy`` and ``hyperres_torch``
(the card's machine has no JAX) and skip without a card; the plain
versions are held to the JAX package in ``tests/test_torch_*.py``.

    python -m pytest tests_gpu -q   # or tests_gpu/fullscale, or --ignore it

``python3 chip_smoke.py`` runs this suite, then the kernel table, in one
process; ``card_inputs.py`` holds the inputs both build once.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the PyTorch port's kernels); "
        "skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda_device(cuda):
    return torch.device("cuda", 0)
