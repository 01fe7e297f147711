"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ with a plain C interface (``csrc/*.cu``),
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library at
first use and loaded with ``ctypes``. The library lands in
``build/hyperres_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of its source and flags so an edited
source is rebuilt. ``load_libraries`` starts one nvcc per source, all
together. There is no fallback: a missing ``nvcc`` or a failed build
raises.
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
from typing import Dict, Sequence

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


def _lib_path(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Compile ``csrc/<name>.cu`` for each name not yet built (once per
    source/flag hash), one nvcc per source, all started together; then
    load them. Raises ``RuntimeError`` with the compiler output if any
    build fails (after every nvcc has ended)."""
    jobs = {}
    for name in names:
        if name in _loaded or name in jobs:
            continue
        src, lib_path = _lib_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, src, lib_path, time.perf_counter())
    errors = []
    for name, (proc, tmp, src, lib_path, t0) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}) building {src}:"
                          f"\n{out}\n{err}")
            continue
        os.replace(tmp, lib_path)
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": (out + err).strip()}
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)[1]))
            build_info.setdefault(name, {"seconds": 0.0, "ptxas": ""})
    return {name: _loaded[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """:func:`load_libraries` for one library."""
    return load_libraries([name])[name]
