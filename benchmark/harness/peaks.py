"""The card's published peaks and the least-time arithmetic of a
roofline, frozen from ``chip_smoke.py`` (``PEAK_*``, ``bound``).

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit:
HBM3 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s; TF32 on the
tensor cores 495 TFLOP/s. A card set below 700 W runs slower under load,
so every roofline line prints the card's ``power.limit`` beside the
peak it used.
"""

from __future__ import annotations

import subprocess
from typing import Dict

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_TC_FLOPS = 495e12


def bound(n_bytes: float, flops: float, peak_flops: float) -> Dict[str, object]:
    """The least seconds for work that moves ``n_bytes`` and does
    ``flops`` operations: the larger of bytes over the HBM peak and
    operations over ``peak_flops``, and which one it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak_flops
    return {"bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops, "peak_flops": peak_flops}


def power_limit_w(index: int = 0):
    """``nvidia-smi``'s power limit of card ``index`` in W, None where it
    cannot be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def roofline_pct(name: str, b: Dict[str, object], seconds: float,
                 power_w, log) -> float:
    """100 x least time / measured time, after logging the counts."""
    pct = 100.0 * b["bound_s"] / seconds
    log(f"roofline {name}: {b['bytes']!r} B, {b['flops']!r} FLOP, peaks "
        f"{PEAK_BYTES_S:g} B/s and {b['peak_flops']:g} FLOP/s (data sheet, "
        f"700 W; this card's power.limit {power_w} W); least "
        f"{b['bound_s']!r} s by {b['bound_by']}, measured {seconds!r} s: "
        f"{pct!r} %")
    return pct
