# Port-owned copy of hyperres/coreg/granule.py: s2_bandmap_from_descriptions
# :20 and closest_band_1based :33 verbatim; coregister_s2_to_emit :38 split
# into its file reads and write and a device-resident core
# (coregister_stack) that runs its attempts, with one departure in what an
# attempt may catch (see its docstring).
"""Granule-level coregistration — API parity with the reference's
``coregister_s2_granule_to_emit_granule`` (s2_emit/arosics_coreg.py:92-184):
band selection from S2 descriptions + EMIT wavelengths, the B08 -> B04
fallback ladder, and the attempts ledger.

:func:`coregister_stack` is the resident core: EMIT bands and the S2
stack as tensors on the device, the ladder's attempts (resample, match,
filters, deshift) there, the deshifted stack returned there in the
input's dtype. :func:`coregister_s2_to_emit` reads the GeoTIFFs, calls
it, and writes its product. Spans (``utils/profiling.py``): the root
``coreg`` over the core's call, and the stages ``coreg.resample``,
``coreg.match``, ``coreg.filter`` and ``coreg.deshift`` (field, warp and
the cast to the input's dtype: one kernel on the card, counted as
``deshift.kernel``).

One deliberate departure: the reference records *any* exception of an
attempt and goes on to the next band (``granule.py:149-152``). Here an
attempt records only data errors (``ValueError``, ``KeyError``,
``OSError``, ``np.linalg.LinAlgError``); anything else, a CUDA error or
a failed kernel launch among them, propagates, so a fault of the device
is never reported as "coregistration failed, use the unshifted stack".
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..core.config import CoregConfig
from ..core.grid import Grid
from ..device import resolve_device
from ..io.granule import EmitGranule
from ..io.tiff import TiffReader, write_geotiff
from ..kernels.warp import resample_to_grid
from ..utils.profiling import span
from .local import _as_tensor, _device_of, coregister_local, deshift_product


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


def coregister_stack(
    emit_bands: Mapping[str, object],
    emit_grid: Grid,
    s2_stack,
    s2_grid: Grid,
    config: CoregConfig = CoregConfig(),
    *,
    s2_bandmap: Mapping[str, int],
    nodata_emit: Optional[float] = None,
    nodata_s2: Optional[float] = None,
    on_product: Optional[Callable[[torch.Tensor], None]] = None,
    device=None,
) -> Dict:
    """Coregister the S2 stack to the EMIT reference on the device: the
    reference's ladder over ``config.prefer_bands`` (B08, then B04).

    ``emit_bands``: band code -> the (He, We) EMIT band nearest the
    code's target wavelength, on ``emit_grid`` (a code without one is
    skipped); ``s2_stack``: (B, H, W) on ``s2_grid``, any dtype;
    ``s2_bandmap``: band code -> 1-based band of the stack. Arrays or
    tensors; everything runs on ``device`` (default: the stack's own
    device where it is a tensor, else the current CUDA device). An
    attempt resamples its EMIT band onto the S2 grid, matches it to the
    S2 band (:func:`~.local.coregister_local`) and deshifts the whole
    stack; ``on_product`` (the file path's write) is called with the
    product inside the attempt. An attempt records a data error
    (:data:`ATTEMPT_ERRORS`) and goes on; any other exception propagates.

    Returns ``{"final", "attempts"}`` as :func:`coregister_s2_to_emit`,
    ``"shifted"``: the (B, H, W) product on the device (u16 for an
    integer stack, float32 for a float one; None where every attempt
    failed) and ``"result"``: the successful attempt's
    :class:`~.local.CoregResult`."""
    cfg = config
    dev = _device_of(s2_stack, device)
    stack = _as_tensor(s2_stack, dev)
    target_nm = dict(cfg.band_target_nm)
    attempts = []
    last_err = None
    with span("coreg", dev):
        for code_raw in cfg.prefer_bands:
            code = str(code_raw).split("_", 1)[0].upper()
            if code not in target_nm or code not in emit_bands:
                continue
            if code not in s2_bandmap:
                attempts.append({"s2_code": code, "success": False,
                                 "error": f"{code} not in S2 template descriptions"})
                continue
            try:
                # bring the EMIT matching band onto the S2 grid
                # (resamp_alg_calc, arosics_coreg.py:108)
                with span("coreg.resample", dev):
                    emit_on_s2 = resample_to_grid(
                        _as_tensor(emit_bands[code], dev, torch.float32),
                        emit_grid, s2_grid, method=cfg.resamp_calc,
                        nodata=nodata_emit, fill=np.nan, device=dev)

                # the EMIT reference carries no energy above its native
                # Nyquist once upsampled onto the S2 grid; mask the
                # cross-power spectrum accordingly
                lowpass = min(1.0, s2_grid.dx / emit_grid.dx)
                res = coregister_local(
                    emit_on_s2, stack[s2_bandmap[code] - 1], config=cfg,
                    ref_nodata=None, tgt_nodata=nodata_s2,
                    lowpass_frac=lowpass, device=dev)
                del emit_on_s2
                if not res.success:
                    attempts.append({"s2_code": code, "success": False,
                                     "error": res.info.get("error", "matching failed")})
                    continue

                with span("coreg.deshift", dev):
                    shifted = deshift_product(
                        stack, res, torch.float32
                        if stack.dtype.is_floating_point else torch.uint16,
                        nodata=nodata_s2, method=cfg.resamp_deshift,
                        local_residuals=cfg.local_residuals,
                        residual_mode=cfg.residual_mode)
                if on_product is not None:
                    on_product(shifted)

                info = {
                    "success": True,
                    "s2_code": code,
                    "s2_match_band_1b": int(s2_bandmap[code]),
                    "grid_res": cfg.grid_res,
                    "max_points": cfg.max_points,
                    "mean_shift_px": list(res.mean_shift_px),
                    "n_tie_points_used": res.info.get("n_used"),
                }
                attempts.append(info)
                return {"final": info, "attempts": attempts,
                        "shifted": shifted, "result": res}
            except ATTEMPT_ERRORS as e:
                last_err = str(e)
                attempts.append({"s2_code": code, "success": False,
                                 "error": last_err})

    return {"final": {"success": False,
                      "error": last_err or "All attempts failed"},
            "attempts": attempts, "shifted": None, "result": None}


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
    float32 export (-9999). Reads the GeoTIFFs, runs
    :func:`coregister_stack` on ``device`` (default the current CUDA
    device; ``"cpu"`` for the CPU) with the EMIT bands nearest each
    target wavelength and the stack in its own dtype, and writes the
    product (u16 for an integer stack, float32 otherwise) inside the
    attempt. An attempt records a data error (:data:`ATTEMPT_ERRORS`)
    and goes on; any other exception propagates."""
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
        s2_stack = t.read()
        s2_grid = t.grid
        s2_desc = t.descriptions
        if nodata_s2 is None:
            nodata_s2 = t.nodata

    with TiffReader(emit_ref_tif) as t:
        emit_stack = t.read()
        emit_grid = t.grid
        emit_nodata_file = t.nodata
    if nodata_emit is None:
        nodata_emit = emit_nodata_file
    emit_bands = {code: emit_stack[b - 1].astype(np.float32)
                  for code, b in emit_match.items()}
    del emit_stack

    def write(shifted: torch.Tensor) -> None:
        write_geotiff(out_s2_tif, shifted.cpu().numpy(), s2_grid,
                      nodata=nodata_s2, descriptions=s2_desc, tiled=True,
                      compress="deflate")

    out = coregister_stack(emit_bands, emit_grid, s2_stack, s2_grid, cfg,
                           s2_bandmap=s2_map, nodata_emit=nodata_emit,
                           nodata_s2=nodata_s2, on_product=write, device=dev)
    final = out["final"]
    if final["success"]:
        b = emit_match[final["s2_code"]]
        final.update(emit_match_band_1b=int(b),
                     emit_match_wl_nm=float(emit_wl_nm[b - 1]))
    return {"final": final, "attempts": out["attempts"],
            "out_s2_tif": str(out_s2_tif)}
