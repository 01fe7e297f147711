"""Plain reference of the EMIT granule ortho export: ``nc_to_envi``'s DATA,
LOC and OBS on the S2-anchored UTM 60 m grid and their u16 products
(martasumyk/hyperspectral_super-resolution ``EMIT_data/emit_proj.py:563-1356``,
the quality mask of ``emit_tools.py:271-298``), in float32 PyTorch (TF32
off) and NumPy.

1. The quality mask: a raw pixel is masked where any of the L2A mask's
   flag bands ``quality_bands`` (0 cloud, 1 cirrus, 3 spacecraft) is
   > 0; the DATA warp's validity is the GLT validity less the ortho cells
   whose raw pixel is masked.
2. The warps: ``granule.warp_to_utm`` (GLT gather, the two-pass cubic
   scanline warp as dense per-line products, renormalised by the warped
   validity, -9999 where it vanishes or the centre leaves the ortho
   grid), for DATA with the masked validity, for LOC and OBS with the GLT
   validity.
3. The u16 products, from their definitions (nodata -9999 in):
   - DATA and its middle band, ``gdal_translate -scale lo hi 0 10000``
     (:989-1012, :248-276): rint((x - lo) 10000 / (hi - lo)), clipped to
     [0, 65534], 65535 for nodata;
   - LOC at its fixed ranges (:399-456): rint((x - lo) 65535 / (hi -
     lo)), clipped to [1, 65535], 0 for nodata;
   - OBS (:459-559): per band the 1st and 99th percentiles of the valid
     values of the UTM cube's [::64, ::64] sample (NumPy's
     ``nanpercentile``: linear rank, in float64), a range of no width
     opened by 1e-6; then as LOC.
   Positions and codes in float64.
4. Where a code is sure: its validity does not hang on the mass test
   (the warped validity mass not within a factor 2 of 1e-6), and its
   position lies farther from a rounding edge than two float32
   evaluations of the product can part: ``TOL_ULPS`` ulps (2^-24) of the
   band's largest source value plus the value itself, over min(1,
   |mass|), plus, for OBS, the same bound on each range, over the mass of
   the samples it was read from.

Departures from ``nc_to_envi``'s GDAL path, as ``granule.py`` notes the
warp's: GDAL warps the GLT-gathered ortho cube with a 2-D cubic
convolution (a = -0.5) renormalised over valid sources; here the GLT
gather and the warp are one step in the two-pass scanline form of the
same kernel, the program's. GDAL's scaling rounds half up where this
rounds half to even, a tie the sure mask leaves out. The diagnostic
band is the cube's middle band (``bands // 2``).

Nothing here imports the program. Matrix products follow
``torch.backends.cuda.matmul.allow_tf32`` (``granule.precision``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .granule import EMIT_NODATA, warp_to_utm

MASS_EPS = 1e-6
#: how far two float32 evaluations of a warped value may part, in ulps
#: (2^-24) of the band's largest |source value| plus the value, before the
#: mass's amplification
TOL_ULPS = 64.0
#: (steps, lowest code, highest code, nodata code) of each u16 product
DATA_CODES = (10000.0, 0.0, 65534.0, 65535)
AUX_CODES = (65535.0, 1.0, 65535.0, 0)
ROWS = 64


def quality_mask(mask: torch.Tensor, bands: Sequence[int]) -> torch.Tensor:
    """Step 1: (H, W) bool, where any of the flag ``bands`` of the (H, W,
    n) L2A mask is > 0."""
    return (mask[..., list(bands)] > 0).any(dim=-1)


def masked_fields(fields: Dict[str, np.ndarray], qmask: torch.Tensor
                  ) -> Dict[str, np.ndarray]:
    """``fields`` (``granule.warp_fields``) with the ortho cells whose raw
    pixel ``qmask`` flags taken out of ``valid``."""
    q = qmask.reshape(-1).cpu().numpy()
    return dict(fields, valid=fields["valid"] & ~q[fields["flat"]])


def weight(mass: torch.Tensor) -> torch.Tensor:
    """min(1, |mass|): how far the renormalisation amplifies rounding."""
    return torch.clamp(mass.abs(), max=1.0)


def mass_sure(mass: torch.Tensor) -> torch.Tensor:
    m = mass.abs()
    return ~((m > 0.5 * MASS_EPS) & (m < 2.0 * MASS_EPS))


def valid_of(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x) & (x != EMIT_NODATA)


def band_big(x: torch.Tensor) -> torch.Tensor:
    """Per band of (H, W, C): the largest |value| of the valid values,
    float64 (C,)."""
    c = x.shape[-1]
    big = torch.zeros(c, dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], ROWS):
        b = x[s:s + ROWS].reshape(-1, c).double()
        big = torch.maximum(big, torch.where(valid_of(b), b.abs(),
                                             0.0).amax(dim=0))
    return big


def band_span(x: torch.Tensor) -> torch.Tensor:
    """Per band of (H, W, C): the range (max - min) of the valid values,
    float64 (C,)."""
    c = x.shape[-1]
    lo = torch.full((c,), float("inf"), dtype=torch.float64, device=x.device)
    hi = torch.full((c,), float("-inf"), dtype=torch.float64,
                    device=x.device)
    for s in range(0, x.shape[0], ROWS):
        b = x[s:s + ROWS].reshape(-1, c).double()
        ok = valid_of(b)
        lo = torch.minimum(lo, torch.where(ok, b, float("inf")).amin(dim=0))
        hi = torch.maximum(hi, torch.where(ok, b, float("-inf")).amax(dim=0))
    return torch.clamp(hi - lo, min=0.0)


def obs_ranges(obs: torch.Tensor, mass: torch.Tensor, stride: int,
               percentiles: Tuple[float, float]) -> Dict[str, np.ndarray]:
    """Step 3's OBS ranges: per band ``lo`` and ``hi`` (float64, the range
    opened by 1e-6 where it has no width), and the least min(1, |mass|)
    of the two samples each was interpolated from (``w_lo``, ``w_hi``)."""
    sample = obs[::stride, ::stride].reshape(-1, obs.shape[-1]).double()
    wmass = weight(mass[::stride, ::stride]).reshape(-1).double()
    c = sample.shape[-1]
    out = {k: np.full(c, np.nan) for k in ("lo", "hi", "w_lo", "w_hi")}
    for b in range(c):
        ok = valid_of(sample[:, b])
        vals, order = torch.sort(sample[ok, b])
        w = wmass[ok][order]
        n = vals.numel()
        if n == 0:
            continue
        for key, q in zip(("lo", "hi"), percentiles):
            pos = q / 100.0 * (n - 1)
            j = int(np.floor(pos))
            jp = min(j + 1, n - 1)
            t = pos - j
            a, bv = float(vals[j]), float(vals[jp])
            # NumPy's lerp, as nanpercentile takes it
            out[key][b] = bv - (bv - a) * (1 - t) if t >= 0.5 \
                else a + (bv - a) * t
            out["w_" + key][b] = float(torch.minimum(w[j], w[jp]))
    out["hi"] = np.where(out["hi"] <= out["lo"], out["lo"] + 1e-6, out["hi"])
    return out


def positions(x: torch.Tensor, lo, hi, steps: float) -> torch.Tensor:
    """Code positions (float64) of values x (..., C) on [lo, hi] (scalars
    or (C,) float64 tensors) in ``steps`` steps."""
    return (x.double() - lo) * (steps / (hi - lo))


def codes(x: torch.Tensor, lo, hi, spec) -> torch.Tensor:
    """Step 3: the u16 codes of x (..., C) by ``spec`` (``DATA_CODES`` or
    ``AUX_CODES``), as int32."""
    steps, q_lo, q_hi, nodata = spec
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], ROWS):
        b = x[s:s + ROWS]
        q = torch.clamp(torch.round(positions(b, lo, hi, steps)), q_lo, q_hi)
        out[s:s + ROWS] = torch.where(valid_of(b), q, float(nodata)).to(
            torch.int32)
    return out


def sure(x: torch.Tensor, mass: torch.Tensor, lo, hi, steps: float,
         big: torch.Tensor, range_tol=0.0) -> torch.Tensor:
    """Step 4 for a block x (rows, W, C) with its mass (rows, W): where
    the code of x is sure. ``big`` (C,): the band's largest |source
    value|; a renormalised value parts by rounding of its numerator (the
    sources) and of its denominator (times the value), over the mass.
    ``range_tol`` (C,): how far each range bound may move (OBS)."""
    s = positions(x, lo, hi, steps)
    w = weight(mass).double()[..., None]
    tol_x = TOL_ULPS * 2.0 ** -24 * (big + x.double().abs()) / w + range_tol
    span = hi - lo
    tol_s = (tol_x * (steps / span) + s.abs() * (2.0 * range_tol / span)
             + 2.0 ** -20 * s.abs())
    edge = 0.5 - (s - torch.round(s)).abs()
    return mass_sure(mass)[..., None] & (~valid_of(x) | (edge > tol_s))


def export(raw: torch.Tensor, loc: torch.Tensor, obs: torch.Tensor,
           mask: torch.Tensor, fields: Dict[str, np.ndarray], ortho: dict
           ) -> Dict[str, object]:
    """Steps 1-3 on one granule: the UTM cubes ``data``, ``loc``, ``obs``
    and their masses ``data_mass``, ``aux_mass``; the codes ``data_u16``
    and ``diag_u16`` (the middle band), ``loc_u16``, ``obs_u16`` (int32);
    the OBS ranges (``obs_lo``, ``obs_hi``, ``obs_w_lo``, ``obs_w_hi``);
    per band the largest |value| of each raw input (``*_big``) and the
    range of each UTM cube (``*_span``)."""
    qmask = quality_mask(mask, ortho["quality_bands"])
    out: Dict[str, object] = {}
    out["data"], out["data_mass"] = warp_to_utm(raw, masked_fields(fields,
                                                                   qmask))
    out["loc"], out["aux_mass"] = warp_to_utm(loc, fields)
    out["obs"], _ = warp_to_utm(obs, fields)
    for k, src in (("data", raw), ("loc", loc), ("obs", obs)):
        out[k + "_big"], out[k + "_span"] = band_big(src), band_span(out[k])
    r = obs_ranges(out["obs"], out["aux_mass"], ortho["obs_sample_stride"],
                   tuple(ortho["obs_percentiles"]))
    out.update({"obs_" + k: v for k, v in r.items()})
    dev = raw.device
    lo, hi = ortho["reflectance_scale"]
    out["data_u16"] = codes(out["data"], float(lo), float(hi), DATA_CODES)
    d = out["data"].shape[-1] // 2
    out["diag_u16"] = out["data_u16"][..., d:d + 1]
    ranges = [ortho["lon_range"], ortho["lat_range"], ortho["elev_range"]]
    out["loc_lo"], out["loc_hi"] = (
        torch.tensor([float(r[i]) for r in ranges], dtype=torch.float64,
                     device=dev) for i in (0, 1))
    out["loc_u16"] = codes(out["loc"], out["loc_lo"], out["loc_hi"],
                           AUX_CODES)
    out["obs_u16"] = codes(out["obs"], torch.as_tensor(r["lo"], device=dev),
                           torch.as_tensor(r["hi"], device=dev), AUX_CODES)
    return out
