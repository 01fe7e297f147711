"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ with a plain C interface (``csrc/*.cu``),
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library at
first use and loaded with ``ctypes``. The library lands in
``build/hyperres_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of its source and flags so an edited
source is rebuilt. There is no fallback: a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyperres_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
#: per library: seconds the build took (0.0 when loaded from an earlier
#: build) and the compiler's register/spill report
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (no CUDA toolkit): the port's "
                           "CUDA kernels cannot be built")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source/flag hash) and load
    it. Raises ``RuntimeError`` with the compiler output on failure."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    info = {"seconds": 0.0, "ptxas": ""}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        info = {"seconds": time.perf_counter() - t0,
                "ptxas": (proc.stdout + proc.stderr).strip()}
    lib = ctypes.CDLL(str(lib_path))
    build_info[name] = info
    _loaded[name] = lib
    return lib
