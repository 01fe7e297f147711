"""The Sentinel-2 stack assembly, truecolor download and grid-snapped
crops (``hyperres/catalog/s2_stack.py``). The rest of ``hyperres/catalog``
(the STAC / CMR clients, pairing, cloud metrics, geometry) is not
ported yet."""

from .s2_stack import (
    S2_STACK_ASSETS, REQUIRED_ASSETS, build_s2_spectral_stack,
    crop_s2_stack_to_te, download_s2_spectral_stack, download_s2_truecolor,
)

__all__ = [
    "S2_STACK_ASSETS", "REQUIRED_ASSETS", "build_s2_spectral_stack",
    "crop_s2_stack_to_te", "download_s2_spectral_stack",
    "download_s2_truecolor",
]
