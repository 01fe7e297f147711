"""Visualisation: RGB quicklooks, side-by-sides, SCL maps, tile plots.

A port-owned, host-only copy of ``hyperres/viz/quicklook.py`` (lines
1-267: the code is the original's, the package imports are the port's;
``tests/test_torch_viz.py`` holds it to the original). NumPy only at
import: ``matplotlib`` and ``cv2`` are imported by the functions that
draw or resize.

Host-side matplotlib ports of the reference's viz layer:
- EMIT ENVI RGB quicklook with wavelength-aware band picking, percentile
  stretch, white balance and gamma (EMIT_data/viz.py:9-143 — including
  fixing its latent missing-import bug, SURVEY.md hard part #7),
- S2 truecolor loaders/resizers and side-by-side panels
  (s2_emit/viz.py:11-75),
- SCL class map with the 12-class colormap (s2_data/cloud_utils.py:109-141),
- paired tile plot with wavelength-aware RGB pick
  (tiles_helpers/utils.py:15-148),
- shared stretch helpers (Spectral_matching notebook).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.constants import SCL_CLASS_NAMES
from ..io import envi
from ..io.tiff import TiffReader

RGB_WAVELENGTHS_NM = {"R": 665.0, "G": 560.0, "B": 490.0}


def nearest_band_index(wavelengths_nm: Sequence[float],
                       target_nm: float) -> int:
    """(EMIT_data/viz.py:9-18)."""
    wl = np.asarray(wavelengths_nm, dtype=np.float64)
    return int(np.nanargmin(np.abs(wl - target_nm)))


def percentile_stretch(x: np.ndarray, pmin: float = 2.0, pmax: float = 98.0
                       ) -> np.ndarray:
    """NaN-aware percentile stretch to [0, 1] (EMIT_data/viz.py:42-68)."""
    lo, hi = np.nanpercentile(x, [pmin, pmax])
    return np.clip((x - lo) / (hi - lo + 1e-12), 0.0, 1.0)


def compute_shared_stretch_params(images: Sequence[np.ndarray],
                                  p_low: float = 2.0, p_high: float = 98.0
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Shared per-channel stretch over several RGB images
    (Spectral_matching notebook)."""
    stack = np.concatenate([np.asarray(im).reshape(-1, im.shape[-1])
                            for im in images], axis=0)
    lo = np.nanpercentile(stack, p_low, axis=0)
    hi = np.nanpercentile(stack, p_high, axis=0)
    return lo, hi


def apply_stretch(img: np.ndarray, lo, hi, gamma: float = 1.0) -> np.ndarray:
    out = np.clip((img - lo) / (np.asarray(hi) - lo + 1e-12), 0, 1)
    if gamma != 1.0:
        out = out ** (1.0 / gamma)
    return out


def emit_rgb_from_cube(cube_hwb: np.ndarray,
                       wavelengths_nm: Sequence[float],
                       nodata: Optional[float] = -9999.0,
                       pmin: float = 2.0, pmax: float = 98.0,
                       white_balance: bool = True,
                       gamma: float = 1.0) -> np.ndarray:
    """(H, W, B) + wavelengths -> stretched (H, W, 3) RGB quicklook
    (show_emit_rgb_from_envi core, EMIT_data/viz.py:70-143)."""
    idx = [nearest_band_index(wavelengths_nm, RGB_WAVELENGTHS_NM[c])
           for c in ("R", "G", "B")]
    rgb = np.asarray(cube_hwb[..., idx], dtype=np.float32)
    if nodata is not None:
        rgb = np.where(rgb == nodata, np.nan, rgb)
    rgb = np.clip(rgb, 0.0, 1.0)
    out = np.stack([percentile_stretch(rgb[..., c], pmin, pmax)
                    for c in range(3)], axis=-1)
    if white_balance:
        means = np.nanmean(out.reshape(-1, 3), axis=0)
        out = np.clip(out * (means.mean() / (means + 1e-12)), 0, 1)
    if gamma != 1.0:
        out = out ** (1.0 / gamma)
    return np.nan_to_num(out)


def show_emit_rgb_from_envi(hdr_path: Union[str, Path],
                            save_path: Union[str, Path, None] = None,
                            title: Optional[str] = None, **kwargs):
    """Load an ENVI cube and render its RGB quicklook."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r = envi.EnviReader(hdr_path)
    cube = r.read().astype(np.float32)
    wl = r.wavelengths
    if wl is None:
        raise ValueError(f"No wavelengths in header {hdr_path}")
    rgb = emit_rgb_from_cube(cube, wl, nodata=r.nodata, **kwargs)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(rgb)
    ax.set_title(title or Path(hdr_path).stem)
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return rgb


def load_s2_rgb_u8(tif_path: Union[str, Path],
                   bands: Tuple[int, int, int] = (0, 1, 2)) -> np.ndarray:
    """(H, W, 3) uint8 from an S2 truecolor GeoTIFF (s2_emit/viz.py:11-17).
    Non-uint8 data is robust-stretched per image EXCLUDING the nodata
    sentinel (a global /max() would let a 65535 sentinel crush valid
    reflectance to black and render nodata white)."""
    with TiffReader(tif_path) as r:
        data = r.read(bands=list(bands))
        nod = r.nodata
    if data.dtype != np.uint8:
        x = data.astype(np.float32)
        valid = np.isfinite(x)
        if nod is not None:
            valid &= x != np.float32(nod)
        finite = x[valid]
        if finite.size:
            lo, hi = np.percentile(finite, [2.0, 98.0])
            hi = hi if hi > lo else lo + 1.0
        else:
            lo, hi = 0.0, 1.0
        x = np.clip((x - lo) / (hi - lo) * 255.0, 0, 255)
        x[~valid] = 0.0
        data = x.astype(np.uint8)
    return np.moveaxis(data, 0, -1)


def resize_s2_rgb_to(rgb_u8: np.ndarray, shape_hw: Tuple[int, int]
                     ) -> np.ndarray:
    """Area-resampled resize (cv2 INTER_AREA, s2_emit/viz.py:19-24)."""
    import cv2
    h, w = shape_hw
    return cv2.resize(rgb_u8, (w, h), interpolation=cv2.INTER_AREA)


def show_side_by_side(img_a: np.ndarray, img_b: np.ndarray,
                      title_a: str = "", title_b: str = "",
                      save_path: Union[str, Path, None] = None):
    """(s2_emit/viz.py:26-31)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    for ax, img, title in zip(axes, (img_a, img_b), (title_a, title_b)):
        ax.imshow(np.nan_to_num(np.asarray(img)))
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def print_raster_geometry(path: Union[str, Path]) -> Dict:
    """Raster geometry dump (s2_emit/viz.py:34-75) — returns the record
    and prints a compact summary."""
    from ..artifacts.metadata import tif_geo_summary
    s = tif_geo_summary(path)
    print(f"{Path(path).name}: {s['width']}x{s['height']}x{s['count']} "
          f"{s['dtype']} crs={s.get('crs')} bounds={s.get('bounds_crs')} "
          f"nodata={s['nodata']}")
    return s


SCL_COLORS = {
    0: "#000000", 1: "#ff0000", 2: "#404040", 3: "#833d0c",
    4: "#00a000", 5: "#e3d911", 6: "#0000cc", 7: "#757171",
    8: "#aeaaa8", 9: "#d0cece", 10: "#50c8e8", 11: "#ff66ff",
}


def plot_scl_map(scl: np.ndarray, save_path: Union[str, Path, None] = None,
                 title: str = "SCL"):
    """12-class SCL map with legend (s2_data/cloud_utils.py:109-141)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import BoundaryNorm, ListedColormap
    from matplotlib.patches import Patch

    cmap = ListedColormap([SCL_COLORS[c] for c in range(12)])
    norm = BoundaryNorm(np.arange(-0.5, 12.5), cmap.N)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(scl, cmap=cmap, norm=norm, interpolation="nearest")
    handles = [Patch(color=SCL_COLORS[c],
                     label=f"{c}: {SCL_CLASS_NAMES.get(c, '?')}")
               for c in range(12)]
    ax.legend(handles=handles, loc="center left", bbox_to_anchor=(1.0, 0.5),
              fontsize=7)
    ax.set_title(title)
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_tile_pair_simple(emit_tif: Union[str, Path],
                          s2_tif: Union[str, Path],
                          save_path: Union[str, Path, None] = None,
                          emit_scale: float = 1e-4):
    """Side-by-side EMIT/S2 tile quicklook with wavelength-aware RGB pick
    from band descriptions when available (tiles_helpers/utils.py:15-148)."""
    with TiffReader(emit_tif) as er:
        emit = er.read().astype(np.float32)
        if er.nodata is not None:
            emit = np.where(emit == er.nodata, np.nan, emit)
        emit = emit * emit_scale
        wl = []
        for d in er.descriptions:
            try:
                wl.append(float(str(d).split()[0]))
            except (ValueError, TypeError, AttributeError):
                wl.append(np.nan)
        wl = np.asarray(wl)
        if np.isfinite(wl).sum() >= 3:
            idx = [int(np.nanargmin(np.abs(wl - RGB_WAVELENGTHS_NM[c])))
                   for c in ("R", "G", "B")]
        else:
            b = emit.shape[0]
            idx = [min(b - 1, int(b * 0.25)), min(b - 1, int(b * 0.17)),
                   min(b - 1, int(b * 0.10))]
        emit_rgb = np.stack([percentile_stretch(emit[i]) for i in idx],
                            axis=-1)
    with TiffReader(s2_tif) as sr:
        codes = [str(d).split("_")[0] for d in (sr.descriptions or [])]
        order = [0, 1, 2]
        if all(c in codes for c in ("B04", "B03", "B02")):
            order = [codes.index("B04"), codes.index("B03"),
                     codes.index("B02")]
        s2 = sr.read(bands=order).astype(np.float32)
        s2_rgb = np.stack([percentile_stretch(s2[i]) for i in range(3)],
                          axis=-1)
    return show_side_by_side(emit_rgb, s2_rgb, "EMIT tile", "S2 tile",
                             save_path=save_path)


def plot_s2_truecolor(tif_path, save_path=None, title: str = "S2 truecolor",
                      bands=(0, 1, 2), pmin: float = 2.0,
                      pmax: float = 98.0):
    """Stretched truecolor quicklook of an S2 visual/RGB GeoTIFF
    (s2_data/s2_utils.py:281-327, :785-822)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rgb = load_s2_rgb_u8(tif_path, bands=bands).astype(np.float32)
    out = np.stack([percentile_stretch(rgb[..., c], pmin, pmax)
                    for c in range(3)], axis=-1)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(out)
    ax.set_title(title)
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out
