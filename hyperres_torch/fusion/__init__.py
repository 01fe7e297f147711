"""Fusion methods and the ridge spectral-SR model (``hyperres/fusion``):
the re-exports of the reference's subpackage; ``fused`` holds the fused
granule plans."""

from .linear import calibrate_linear
from .histogram import histogram_match_rgb
from .ot import (
    fit_ot_affine, apply_affine, ot_match_rgb_sinkhorn,
    fit_ot_poly, apply_poly,
)
from .ridge_sr import (RidgeSpectralSR, RidgeSRParams, flatten_pixels,
                       save_params, load_params)
from .sampling import sample_valid_pixels_host, sample_valid_pixels_device

__all__ = [
    "calibrate_linear", "histogram_match_rgb",
    "fit_ot_affine", "apply_affine", "ot_match_rgb_sinkhorn",
    "fit_ot_poly", "apply_poly",
    "RidgeSpectralSR", "RidgeSRParams", "flatten_pixels",
    "save_params", "load_params",
    "sample_valid_pixels_host", "sample_valid_pixels_device",
]
