"""The coregistration cell's data, made from the seed on the device.

The world is that of the granule scene (``scene.py``: its four smooth
abundance fields from seed 0, the four endmember spectra) with a
band-limited texture added to each field: ``TEXTURE_TERMS`` plane waves
per field, wavelengths 0.2-3 km (uniform over that annulus of spatial
frequency), random directions and phases, from ``TEXTURE_SEED``. The
world's own fields have 7-42 km wavelengths and leave a 5.12 km matching
window with less than one cycle; fields, roads and relief carry
structure at the texture's scales.

- The EMIT reference: the band nearest ``EMIT_MATCH_NM`` of the world
  at the centres of the S2-anchored UTM 60 m grid, plus sensor noise
  (``EMIT_NOISE``, from the run's seed), float32; ``EMIT_NODATA``
  outside the raw swath (the GLT's footprint).
- The S2 targets: the world through the ten bands' responses at the 10
  m centres displaced by an affine field per target, drawn from the seed
  (a translation of 2-8 px per axis, each sign drawn, and a linear term
  of up to 1 px per axis across the footprint, centred), plus noise
  (``S2_NOISE``); u16 DN (scale 1e-4), the first 5 % of the pixels in
  row-major order ``S2_NODATA`` in every band.

A target pixel (r, c) shows the world at the grid position (r - dy(r,
c), c - dx(r, c)): the program should measure (dy, dx). Each field is a
sum of plane waves whose phase is affine in (r, c) under an affine
displacement, so a field is evaluated exactly, with no interpolation,
as one matrix product of per-row and per-column sines and cosines
(sin(a r + b c + g) = sin(a r + g) cos(b c) + cos(a r + g) sin(b c)).
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .geometry import GridSpec
from .scene import _world_params, swath_geometry
from .spectra import (emit_wavelength_grid, endmember_spectra,
                      srf_weight_matrix)

#: the S2 stack: description, S2A centre and width (nm), in the order of
#: the repository's 10-band stack (B02, B03, B04, B08, then the 20 m bands)
S2_BANDS: Tuple[Tuple[str, float, float], ...] = (
    ("B02_blue", 492.4, 66.0), ("B03_green", 559.8, 36.0),
    ("B04_red", 664.6, 31.0), ("B08_nir", 832.8, 106.0),
    ("B05_rededge1", 704.1, 15.0), ("B06_rededge2", 740.5, 15.0),
    ("B07_rededge3", 782.8, 20.0), ("B8A_nir08", 864.7, 21.0),
    ("B11_swir16", 1613.7, 91.0), ("B12_swir22", 2202.4, 175.0))
EMIT_MATCH_NM = 842.0
TEXTURE_SEED = 19
TEXTURE_WAVELENGTH_KM = (0.2, 3.0)
TEXTURE_TERMS = 256
#: root mean square of each field's texture, in the field's units (the
#: world's own fields sum four unit sines)
TEXTURE_RMS = 0.35
EMIT_NOISE = 0.002
S2_NOISE = 0.001
EMIT_NODATA = -9999.0
S2_NODATA = 65535
S2_SCALE = 1e-4
NODATA_SHARE = 20


def s2_responses(step_nm: float = 1.0, exponent: float = 4.0):
    """{band: (nm, response)} of :data:`S2_BANDS`, the super-Gaussian of
    ``spectra.s2a_srf``."""
    out = {}
    for name, centre, width in S2_BANDS:
        lam = np.arange(centre - width, centre + width + step_nm, step_nm)
        resp = np.exp(-((2.0 * np.abs(lam - centre) / width)
                        ** (2.0 * exponent)))
        keep = resp > 1e-4
        out[name] = (lam[keep], resp[keep])
    return out


def world_terms() -> List[np.ndarray]:
    """Per abundance field, its plane waves (n, 4): spatial frequencies
    (fx, fy) in rad/km, phase, amplitude; the world's own four
    harmonics (amplitude 1) first, then the texture."""
    rng = np.random.default_rng(TEXTURE_SEED)
    lo, hi = (2.0 * np.pi / w for w in TEXTURE_WAVELENGTH_KM[::-1])
    amp = TEXTURE_RMS * np.sqrt(2.0 / TEXTURE_TERMS)
    out = []
    for phase, freq in _world_params():
        k = np.sqrt(rng.uniform(lo * lo, hi * hi, TEXTURE_TERMS))
        th = rng.uniform(0.0, 2.0 * np.pi, TEXTURE_TERMS)
        q = rng.uniform(0.0, 2.0 * np.pi, TEXTURE_TERMS)
        base = np.column_stack([freq[:, 0], freq[:, 1], phase,
                                np.ones(len(phase))])
        tex = np.column_stack([k * np.cos(th), k * np.sin(th), q,
                               np.full(TEXTURE_TERMS, amp)])
        out.append(np.concatenate([base, tex]))
    return out


def fields(grid: GridSpec, affine_px, device, rows=None, cols=None
           ) -> torch.Tensor:
    """(4, h, w) float32: each abundance field (before its exponential)
    at the pixels (rows x cols, default the whole grid) of ``grid``
    displaced by ``affine_px`` = ((a0, a1, a2), (b0, b1, b2)): pixel (r,
    c) shows the world at (r - dy, c - dx), dy = a0 + a1 r + a2 c, dx =
    b0 + b1 r + b2 c. The phases in float64 on ``device``, the product
    of the per-row and per-column factors in float32."""
    (a0, a1, a2), (b0, b1, b2) = affine_px
    f64 = dict(dtype=torch.float64, device=device)
    r = torch.arange(grid.height, **f64) if rows is None \
        else torch.as_tensor(rows, **f64)
    c = torch.arange(grid.width, **f64) if cols is None \
        else torch.as_tensor(cols, **f64)
    # x = x0 + (c' + 0.5) dx, y = y0 - (r' + 0.5) dy, in km
    sx, sy = grid.dx / 1000.0, grid.dy / 1000.0
    out = []
    for t in world_terms():
        fx, fy, ph, amp = torch.as_tensor(t, **f64).unbind(1)
        # phase = fx x + fy y + ph = alpha r + beta c + gamma
        alpha = sx * fx * (-b1) - sy * fy * (1.0 - a1)
        beta = sx * fx * (1.0 - b2) + sy * fy * a2
        gamma = (fx * (grid.x0 / 1000.0 + 0.5 * sx)
                 + fy * (grid.y0 / 1000.0 - 0.5 * sy) + ph
                 + sx * fx * (-b0) + sy * fy * a0)
        ar = torch.remainder(r[:, None] * alpha + gamma, 2.0 * np.pi)
        bc = torch.remainder(c[:, None] * beta, 2.0 * np.pi)
        left = torch.cat([torch.sin(ar), torch.cos(ar)], dim=1)
        right = torch.cat([amp * torch.cos(bc), amp * torch.sin(bc)],
                          dim=1)
        out.append(left.to(torch.float32) @ right.T.to(torch.float32))
    return torch.stack(out)


def reflectance(f: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """(S, h, w): the abundances exp(0.8 f), normalised over the four
    fields, through the (4, S) band values."""
    a = torch.exp(0.8 * f)
    a /= a.sum(dim=0, keepdim=True)
    k, h, w = a.shape
    return (spec.T @ a.reshape(k, h * w)).reshape(-1, h, w)


def draw_affine(rng: np.random.Generator, h: int, w: int):
    """One target's displacement in px: a translation of 2-8 px per
    axis (sign drawn) plus a centred linear term of up to 1 px per axis
    across the footprint (so up to 2 px between corners)."""
    out = []
    for _ in range(2):
        t = rng.uniform(2.0, 8.0) * rng.choice([-1.0, 1.0])
        lr, lc = rng.uniform(-1.0, 1.0, 2)
        out.append((t - 0.5 * lr - 0.5 * lc, lr / h, lc / w))
    return tuple(out)


def swath_inside(geo: Dict[str, object], raw_h: int, raw_w: int
                 ) -> np.ndarray:
    """(h60, w60) bool: the UTM 60 m centres inside the raw swath, by the
    GLT's rounding (``scene.swath_geometry``)."""
    g = geo["utm60"]
    xs, ys = g.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    cx, cy, th = 450000.0, 5770000.0, np.radians(13.0)
    du = (X - cx) * np.cos(th) + (Y - cy) * np.sin(th)
    dv = -(X - cx) * np.sin(th) + (Y - cy) * np.cos(th)
    ci = np.round(du / 60.0 + raw_w / 2.0)
    ri = np.round(-dv / 60.0 + raw_h / 2.0)
    return (ri >= 0) & (ri < raw_h) & (ci >= 0) & (ci < raw_w)


def coreg_scene(raw_hw, targets: int, seed: int, device,
                bands: int = len(S2_BANDS)) -> Dict[str, object]:
    """The cell's data: ``emit`` (h60, w60) float32 and ``stacks``, a
    list of ``targets`` (bands, h10, w10) uint16 tensors on ``device``;
    ``affine``, each target's displacement (:func:`draw_affine`);
    ``descriptions`` of the stack's bands; the grids ``utm60`` and
    ``s2_grid``; ``emit_wl``, the EMIT band's wavelength."""
    raw_h, raw_w = raw_hw
    geo = swath_geometry(raw_h, raw_w)
    s2, utm = geo["s2_grid"], geo["utm60"]
    wl, good = emit_wavelength_grid(285)
    spectra = endmember_spectra(wl)
    k = int(np.argmin(np.abs(wl - EMIT_MATCH_NM)))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    rng = np.random.default_rng(int(seed))

    emit_spec = torch.as_tensor(spectra[:, k:k + 1], dtype=torch.float32,
                                device=device)
    emit = reflectance(fields(utm, ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                              device), emit_spec)[0]
    emit += EMIT_NOISE * torch.randn(emit.shape, generator=gen,
                                     device=device)
    inside = torch.as_tensor(swath_inside(geo, raw_h, raw_w), device=device)
    emit.masked_fill_(~inside, EMIT_NODATA)

    names = [b[0] for b in S2_BANDS[:bands]]
    w_s2 = srf_weight_matrix(wl, s2_responses(), good, bands=names)
    s2_spec = torch.as_tensor(spectra @ w_s2.astype(np.float64),
                              dtype=torch.float32, device=device)
    stacks, affines = [], []
    for _ in range(targets):
        aff = draw_affine(rng, s2.height, s2.width)
        refl = reflectance(fields(s2, aff, device), s2_spec)
        refl += S2_NOISE * torch.randn(refl.shape, generator=gen,
                                       device=device)
        dn = torch.clamp(torch.round(refl.mul_(1.0 / S2_SCALE)), 0,
                         S2_NODATA - 1)
        del refl
        q = dn.to(torch.int32).to(torch.uint16)
        del dn
        q.view(q.shape[0], -1)[:, :q[0].numel() // NODATA_SHARE] = S2_NODATA
        stacks.append(q)
        affines.append(aff)
    return {"emit": emit, "stacks": stacks, "affine": affines,
            "descriptions": names, "utm60": utm, "s2_grid": s2,
            "emit_wl": float(wl[k])}
