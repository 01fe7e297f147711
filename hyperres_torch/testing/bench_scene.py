"""The synthetic full-granule bench scene, without JAX.

A copy of ``bench._generate_scene`` (``bench.py:124-236``) and of the
three ``hyperres/testing/scenes.py`` helpers it calls, built on the
port's own host copies (``kernels.host``, ``spectral.srf_tables``)
instead of the reference's JAX modules. ``tests/test_torch_host.py``
holds :func:`generate_scene` equal to ``bench._generate_scene``.

Scale 1.0 gives the implied real EMIT granule: raw 1242 x 1280 x 285,
a 1523 x 1550 UTM 60 m grid and a 9140 x 9309 10 m S2 grid.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..core.constants import EMIT_BANDS
from ..core.crs import CRS
from ..core.grid import Grid, s2_anchored_target_grid

from ..kernels.host import build_srf_weight_matrix
from ..spectral.srf_tables import builtin_srf

#: bump when the generator changes so stale caches are not read
SCENE_VERSION = 1
SCENE_KEYS = ("raw", "s2_dn", "wavelengths", "good_mask", "spectra",
              "ortho_grid", "utm60", "s2_grid", "glt")
#: default scene cache (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".scenecache"


# -- hyperres/testing/scenes.py:53 -------------------------------------------

def emit_wavelength_grid(n_bands: int = EMIT_BANDS) -> Tuple[np.ndarray, np.ndarray]:
    """EMIT-like wavelength axis (380-2493 nm, ~7.43 nm pitch) and a
    good-band mask that blanks the atmospheric water absorption windows."""
    wl = np.linspace(381.0, 2493.0, n_bands)
    good = np.ones(n_bands, dtype=bool)
    good &= ~((wl > 1325.0) & (wl < 1475.0))
    good &= ~((wl > 1770.0) & (wl < 1975.0))
    return wl, good


# -- hyperres/testing/scenes.py:63 -------------------------------------------

def endmember_spectra(wl: np.ndarray) -> np.ndarray:
    """(K, B) smooth endmember spectra in [0.01, 0.9]."""
    wl = np.asarray(wl, dtype=np.float64)
    x = (wl - wl.min()) / (wl.max() - wl.min())

    # vegetation: low visible, sharp red edge near 700 nm, NIR plateau,
    # SWIR water dips
    veg = (0.05 + 0.45 / (1.0 + np.exp(-(wl - 710.0) / 18.0))
           - 0.12 * np.exp(-0.5 * ((wl - 1450.0) / 90.0) ** 2)
           - 0.10 * np.exp(-0.5 * ((wl - 1940.0) / 110.0) ** 2)
           + 0.04 * np.exp(-0.5 * ((wl - 560.0) / 40.0) ** 2))
    # soil: gently increasing ramp with broad clay feature
    soil = (0.12 + 0.35 * x - 0.06 * np.exp(-0.5 * ((wl - 2200.0) / 80.0) ** 2))
    # water: dark, decaying
    water = 0.08 * np.exp(-3.0 * x) + 0.01
    # urban/bright: high flat with mild slope
    urban = 0.35 + 0.15 * x

    out = np.stack([veg, soil, water, urban], axis=0)
    return np.clip(out, 0.01, 0.9)


# -- hyperres/testing/scenes.py:85 -------------------------------------------

def abundance_maps(x_m: np.ndarray, y_m: np.ndarray,
                   seed: int = 0,
                   freq_range: Tuple[float, float] = (0.15, 0.9),
                   n_harmonics: int = 4) -> np.ndarray:
    """(..., K) smooth positive abundance fields over UTM coords (metres),
    normalised to sum to 1. Deterministic given the seed.
    ``freq_range`` (cycles/km) and ``n_harmonics`` set the world's
    spatial texture."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x_m, dtype=np.float64) / 1000.0
    y = np.asarray(y_m, dtype=np.float64) / 1000.0
    fields = []
    for k in range(4):
        phase = rng.uniform(0, 2 * np.pi, size=n_harmonics)
        freq = rng.uniform(freq_range[0], freq_range[1],
                           size=(n_harmonics, 2))
        f = np.zeros_like(x)
        for p, (fx, fy) in zip(phase, freq):
            f = f + np.sin(fx * x + fy * y + p)
        fields.append(np.exp(0.8 * f * (4.0 / n_harmonics) ** 0.5))
    a = np.stack(fields, axis=-1)
    return a / a.sum(axis=-1, keepdims=True)


# -- bench.py:124 ------------------------------------------------------------

def generate_scene(scale: float = 1.0, seed: int = 0) -> dict:
    """The bench scene at ``scale`` of the full granule: the raw cube
    (f32), the 10 m S2 RGB as uint16 DN (scale 1e-4, nodata 65535), the
    wavelength grid, good-band mask, endmember spectra, GLT and the
    three grids (ortho, UTM 60 m, S2 10 m)."""
    rng = np.random.default_rng(seed)
    raw_h = max(64, int(1242 * scale))
    raw_w = max(64, int(1280 * scale))
    n_bands = 285

    wl, good = emit_wavelength_grid(n_bands)
    spectra = endmember_spectra(wl)

    utm = CRS.utm(33, True)
    # swath geometry like the scene factory, sized to the raw dims
    cx, cy = 450000.0, 5770000.0
    th = np.radians(13.0)

    rows, cols = np.meshgrid(np.arange(raw_h), np.arange(raw_w),
                             indexing="ij")
    u = (cols - raw_w / 2.0) * 60.0
    v = -(rows - raw_h / 2.0) * 60.0
    rx = cx + u * np.cos(th) - v * np.sin(th)
    ry = cy + u * np.sin(th) + v * np.cos(th)
    # f32 accumulation: the f64 matmul product + full-cube f64 noise +
    # their sum would peak ~11 GB host RSS at full scale
    a = abundance_maps(rx, ry).astype(np.float32)
    raw = a @ spectra.astype(np.float32)
    del a
    noise = rng.standard_normal(size=(raw_h, raw_w, n_bands),
                                dtype=np.float32)
    noise *= np.float32(0.002)
    raw += noise
    del noise
    np.clip(raw, 0.005, 0.95, out=raw)

    lon, lat = utm.to_geographic(rx, ry)
    res_x = 60.0 / 111320.0 / np.cos(np.radians(float(lat.mean())))
    res_y = 60.0 / 111320.0
    lon0 = float(lon.min()) - res_x
    lat0 = float(lat.max()) + res_y
    ow = int(np.ceil((float(lon.max()) + res_x - lon0) / res_x))
    oh = int(np.ceil((lat0 - (float(lat.min()) - res_y)) / res_y))
    ortho_grid = Grid(CRS.geographic(), lon0, lat0, res_x, res_y, ow, oh)

    # GLT (1-based) for the ortho grid
    oxs, oys = ortho_grid.pixel_center_coords()
    olon, olat = np.meshgrid(oxs, oys)
    oux, ouy = utm.from_geographic(olon, olat)
    du = (oux - cx) * np.cos(th) + (ouy - cy) * np.sin(th)
    dv = -(oux - cx) * np.sin(th) + (ouy - cy) * np.cos(th)
    ci = np.round(du / 60.0 + raw_w / 2.0).astype(np.int64)
    ri = np.round(-dv / 60.0 + raw_h / 2.0).astype(np.int64)
    inside = (ri >= 0) & (ri < raw_h) & (ci >= 0) & (ci < raw_w)
    glt = np.zeros((oh, ow, 2), dtype=np.int32)
    glt[..., 0] = np.where(inside, ci + 1, 0)
    glt[..., 1] = np.where(inside, ri + 1, 0)

    # S2 grid covering the swath (10 m, origin on the 60 m lattice)
    sw_l = float(oux.min())
    sw_t = float(ouy.max())
    s2_x0 = np.floor(sw_l / 60.0) * 60.0
    s2_y0 = np.ceil(sw_t / 60.0) * 60.0
    s2_w = int((float(oux.max()) - s2_x0) // 10.0)
    s2_h = int((s2_y0 - float(ouy.min())) // 10.0)
    s2_grid = Grid(utm, s2_x0, s2_y0, 10.0, 10.0, s2_w, s2_h)
    utm60 = s2_anchored_target_grid(ortho_grid, s2_grid, 60.0, 60.0)

    # real S2 RGB at 10 m (B2, B3, B4): the world convolved with the
    # S2 SRFs, delivered as uint16 DN at scale 1e-4. The world's
    # abundance fields are band-limited below 0.9 cycles/km, so sampling
    # them on a 30 m lattice and bilinearly refining to 10 m is exact to
    # visual/statistical purposes and ~9x cheaper.
    srf3 = builtin_srf("S2A", bands=["B2", "B3", "B4"])
    W3, _, _ = build_srf_weight_matrix(wl, srf3, good)
    band_spec = (spectra @ np.asarray(W3)).astype(np.float32)  # (K, 3)
    f = 3  # 30 m coarse lattice in 10 m pixel units
    cj = np.arange(0, s2_w + f, f)
    ci = np.arange(0, s2_h + f, f)
    cX = s2_grid.x0 + (cj + 0.5) * s2_grid.dx
    cY = s2_grid.y0 - (ci + 0.5) * s2_grid.dy
    CX, CY = np.meshgrid(cX, cY)
    a_c = abundance_maps(CX, CY).astype(np.float32)
    rgb_c = np.clip(a_c @ band_spec, 0.0, 1.0)  # (Ci, Cj, 3)
    jj = np.arange(s2_w, dtype=np.float64) / f
    j0 = np.floor(jj).astype(np.int64)
    tj = (jj - j0).astype(np.float32)[None, :, None]
    ii = np.arange(s2_h, dtype=np.float64) / f
    i0 = np.floor(ii).astype(np.int64)
    ti = (ii - i0).astype(np.float32)[:, None, None]
    rows_interp = (rgb_c[i0] * (1.0 - ti) + rgb_c[i0 + 1] * ti)
    rgb10 = (rows_interp[:, j0] * (1.0 - tj)
             + rows_interp[:, j0 + 1] * tj)
    s2_dn = np.moveaxis(
        np.clip(np.rint(rgb10 * 10000.0), 0, 65534), -1, 0
    ).astype(np.uint16)
    del rgb_c, rows_interp, rgb10

    return {
        "raw": raw,
        "s2_dn": s2_dn,
        "wavelengths": wl,
        "good_mask": good,
        "spectra": spectra,
        "ortho_grid": ortho_grid,
        "utm60": utm60,
        "s2_grid": s2_grid,
        "glt": glt,
    }


def load_or_generate_scene(scale: float = 1.0, seed: int = 0,
                           cache_dir: Optional[Path] = CACHE_DIR) -> dict:
    """:func:`generate_scene`, memoised under ``cache_dir`` (``None``
    disables the cache). The cache holds pickles this function wrote;
    a file that does not load is regenerated."""
    if cache_dir is None:
        return generate_scene(scale, seed)
    path = Path(cache_dir) / f"scene_v{SCENE_VERSION}_s{scale}_r{seed}.pkl"
    if path.exists():
        with open(path, "rb") as fh:
            scene = pickle.load(fh)
        if all(k in scene for k in SCENE_KEYS):
            return scene
    scene = generate_scene(scale, seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(scene, fh, protocol=5)
    os.replace(tmp, path)
    return scene
