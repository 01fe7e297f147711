"""Coregistration of an S2 stack to an EMIT reference (``hyperres/coreg``):
tie-point phase correlation, the affine / local shift field and the
deshift warp, the device-resident core and the granule-level entry
point."""

from .local import (CoregResult, TiePoint, coregister_local,
                    deshift, shift_field)
from .granule import (
    coregister_s2_to_emit, coregister_stack, s2_bandmap_from_descriptions,
    closest_band_1based,
)

__all__ = [
    "CoregResult", "TiePoint", "coregister_local", "deshift",
    "shift_field",
    "coregister_s2_to_emit", "coregister_stack",
    "s2_bandmap_from_descriptions",
    "closest_band_1based",
]
