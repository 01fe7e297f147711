"""Test configuration: run JAX on CPU with 8 virtual devices so multi-chip
sharding paths are exercised without TPU hardware.

NOTE: jax may already be imported by the interpreter environment, so env
vars (JAX_PLATFORMS / XLA_FLAGS) are too late — use jax.config instead.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # for subprocesses
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # XLA_FLAGS fallback above covers older jax

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the PyTorch port's kernels); "
        "skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("8 virtual CPU devices unavailable")
    return devs


@pytest.fixture
def repo_root():
    from pathlib import Path
    return Path(__file__).resolve().parent.parent
