"""Precision policy, device helper and kernel launch counters.

Precision: every float32 product in the port runs in full f32. The JAX
reference is exact f32 on the CPU, and TF32 (about three decimal
digits) would break parity, so both TF32 switches are turned off when
this module is imported.

Launch counters: each hand-written kernel's wrapper adds one to its
count where it launches the kernel and nowhere else, so a run can show
that its main path went through the kernel (``chip_smoke.py`` resets
the counts, drives the plan and reads them back).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: launches per kernel name since the last :func:`reset_launch_counts`
launch_counts: Dict[str, int] = {}


def count_launch(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def reset_launch_counts() -> None:
    launch_counts.clear()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the current
    CUDA device, so the port's entry points run on the card unless the
    caller asks for ``"cpu"``. A CUDA device that is not there, asked for
    or by default, raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested (None means the card) "
                           "but CUDA is not available; pass device='cpu' "
                           "to run on the CPU")
    if device is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
