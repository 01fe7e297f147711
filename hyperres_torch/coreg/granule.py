# Port-owned copy of hyperres/coreg/granule.py: s2_bandmap_from_descriptions
# :20 and closest_band_1based :33 verbatim; coregister_s2_to_emit :38 with
# its resample and coregistration on the device, and one departure in what
# an attempt may catch (see its docstring).
"""Granule-level coregistration — API parity with the reference's
``coregister_s2_granule_to_emit_granule`` (s2_emit/arosics_coreg.py:92-184):
band selection from S2 descriptions + EMIT wavelengths, the B08 -> B04
fallback ladder, and the attempts ledger.

One deliberate departure: the reference records *any* exception of an
attempt and goes on to the next band (``granule.py:149-152``). Here an
attempt records only data errors (``ValueError``, ``KeyError``,
``OSError``, ``np.linalg.LinAlgError``); anything else, a CUDA error or
a failed kernel launch among them, propagates, so a fault of the device
is never reported as "coregistration failed, use the unshifted stack".
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ..core.config import CoregConfig
from ..device import resolve_device
from ..io.granule import EmitGranule
from ..io.tiff import TiffReader, write_geotiff
from ..kernels.warp import resample_to_grid
from .local import coregister_local, deshift


#: what an attempt records and goes on from: errors of the data, not of
#: the device (the reference catches every Exception, granule.py:149)
ATTEMPT_ERRORS = (ValueError, KeyError, OSError, np.linalg.LinAlgError)


def s2_bandmap_from_descriptions(descriptions) -> Dict[str, int]:
    """Band code -> 1-based index from descriptions like "B04_red"
    (arosics_coreg.py:8-20)."""
    if not descriptions or all(d is None for d in descriptions):
        raise ValueError("S2 template has no band descriptions")
    bandmap = {}
    for i, d in enumerate(descriptions, start=1):
        if not d:
            continue
        bandmap[str(d).split("_", 1)[0].upper()] = i
    return bandmap


def closest_band_1based(wavelengths_nm: np.ndarray, target_nm: float) -> int:
    return int(np.argmin(np.abs(
        np.asarray(wavelengths_nm, float) - float(target_nm)))) + 1


def coregister_s2_to_emit(
    *,
    emit_ref_tif: Union[str, Path],
    s2_tgt_tif: Union[str, Path],
    emit_nc_path: Union[str, Path],
    s2_template_tif: Union[str, Path, None] = None,
    out_s2_tif: Union[str, Path],
    config: CoregConfig = CoregConfig(),
    nodata_emit: Optional[float] = None,
    nodata_s2: Optional[float] = None,
    device=None,
) -> Dict:
    """Coregister an S2 granule to an EMIT reference; returns the
    reference's result schema {"final", "attempts", "out_s2_tif"}.
    ``nodata_emit=None`` (default) takes the reference GeoTIFF's own
    nodata tag — correct for both the u16 product export (65535) and a
    float32 export (-9999). The resample, the phase correlation and the
    deshift warp run on ``device`` (default the current CUDA device;
    ``"cpu"`` for the CPU). An attempt records a data error
    (:data:`ATTEMPT_ERRORS`) and goes on; any other exception
    propagates."""
    cfg = config
    dev = resolve_device(device)
    target_nm = dict(cfg.band_target_nm)

    with TiffReader(s2_template_tif or s2_tgt_tif) as t:
        s2_map = s2_bandmap_from_descriptions(t.descriptions)

    with EmitGranule(emit_nc_path) as g:
        emit_wl_nm = g.wavelengths

    emit_match = {k: closest_band_1based(emit_wl_nm, v)
                  for k, v in target_nm.items()}

    with TiffReader(s2_tgt_tif) as t:
        s2_stack_raw = t.read()
        s2_dtype_in = s2_stack_raw.dtype
        s2_stack = s2_stack_raw.astype(np.float32)
        del s2_stack_raw
        s2_grid = t.grid
        s2_desc = t.descriptions
        if nodata_s2 is None:
            nodata_s2 = t.nodata

    with TiffReader(emit_ref_tif) as t:
        emit_stack = t.read().astype(np.float32)
        emit_grid = t.grid
        emit_nodata_file = t.nodata
    if nodata_emit is None:
        nodata_emit = emit_nodata_file

    attempts = []
    last_err = None
    for code_raw in cfg.prefer_bands:
        code = str(code_raw).split("_", 1)[0].upper()
        if code not in target_nm:
            continue
        if code not in s2_map:
            attempts.append({"s2_code": code, "success": False,
                             "error": f"{code} not in S2 template descriptions"})
            continue
        try:
            emit_band = emit_stack[emit_match[code] - 1]
            s2_band = s2_stack[s2_map[code] - 1]

            # bring the EMIT matching band onto the S2 grid
            # (resamp_alg_calc, arosics_coreg.py:108)
            emit_on_s2 = resample_to_grid(
                emit_band, emit_grid, s2_grid, method=cfg.resamp_calc,
                nodata=nodata_emit, fill=np.nan, device=dev)

            # the EMIT reference carries no energy above its native
            # Nyquist once upsampled onto the S2 grid; mask the
            # cross-power spectrum accordingly
            lowpass = min(1.0, s2_grid.dx / emit_grid.dx)
            res = coregister_local(
                emit_on_s2, s2_band, config=cfg,
                ref_nodata=None, tgt_nodata=nodata_s2,
                lowpass_frac=lowpass, device=dev)
            if not res.success:
                attempts.append({"s2_code": code, "success": False,
                                 "error": res.info.get("error", "matching failed")})
                continue

            shifted = deshift(s2_stack, res, nodata=nodata_s2,
                              method=cfg.resamp_deshift,
                              local_residuals=cfg.local_residuals,
                              residual_mode=cfg.residual_mode,
                              device=dev)
            # preserve the INPUT dtype (the stack was cast to float32
            # for matching; dtype parity with the source export matters)
            out_dtype = (np.uint16 if np.issubdtype(s2_dtype_in,
                                                    np.integer)
                         else np.float32)
            write_geotiff(
                out_s2_tif,
                np.clip(np.nan_to_num(shifted,
                                      nan=nodata_s2 if nodata_s2 is not None
                                      else 0.0),
                        0, 65535).astype(out_dtype)
                if out_dtype == np.uint16 else shifted.astype(np.float32),
                s2_grid, nodata=nodata_s2,
                descriptions=s2_desc, tiled=True, compress="deflate")

            info = {
                "success": True,
                "s2_code": code,
                "s2_match_band_1b": int(s2_map[code]),
                "emit_match_band_1b": int(emit_match[code]),
                "emit_match_wl_nm": float(emit_wl_nm[emit_match[code] - 1]),
                "grid_res": cfg.grid_res,
                "max_points": cfg.max_points,
                "mean_shift_px": list(res.mean_shift_px),
                "n_tie_points_used": res.info.get("n_used"),
            }
            attempts.append(info)
            return {"final": info, "attempts": attempts,
                    "out_s2_tif": str(out_s2_tif)}
        except ATTEMPT_ERRORS as e:
            last_err = str(e)
            attempts.append({"s2_code": code, "success": False,
                             "error": last_err})

    return {"final": {"success": False,
                      "error": last_err or "All attempts failed"},
            "attempts": attempts, "out_s2_tif": str(out_s2_tif)}
