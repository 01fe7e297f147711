"""Self-contained interactive quicklook: one HTML file, zero deps.

A port-owned, host-only copy of ``hyperres/viz/interactive.py`` (lines
1-326: the code is the original's, the package imports are the port's;
``tests/test_torch_viz.py`` holds it to the original).

The reference's interactive exploration surface is a notebook with
hvplot/panel widgets over an orthorectified EMIT cube
(legacy_notebooks/EMIT_experiments.ipynb: band browsing + quicklooks).
This framework targets headless/production environments, so the
equivalent is a single exported HTML file with the (subsampled) cube
embedded as base64 and plain-JS interaction:

- band slider with wavelength readout (hvplot band browser equivalent),
- RGB composite mode (nearest bands to chosen R/G/B wavelengths),
- per-band robust stretch with a gamma slider,
- click any pixel to plot its full spectrum in physical units
  (reflectance/radiance), with good-band gaps left visible.

Everything renders on a <canvas>; no JS libraries, no server, works
from file:// — open in any browser.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_DEFAULT_RGB_NM = (650.0, 560.0, 470.0)


def _subsample_axis(n: int, limit: int) -> np.ndarray:
    if n <= limit:
        return np.arange(n)
    return np.linspace(0, n - 1, limit).round().astype(int)


def prepare_viewer_payload(
    cube_hwb: np.ndarray,
    wavelengths_nm: Optional[Sequence[float]] = None,
    *,
    nodata: Optional[float] = None,
    good_bands: Optional[np.ndarray] = None,
    max_size: int = 640,
    max_bands: int = 96,
    stretch: Tuple[float, float] = (2.0, 98.0),
) -> dict:
    """Subsample + quantize the cube for embedding.

    Spatial striding to ``max_size``; up to ``max_bands`` evenly spaced
    bands; per-band robust [pmin, pmax] percentile scaling to u8 with
    the (lo, hi) kept so the spectrum plot shows physical values."""
    cube = np.asarray(cube_hwb)
    if cube.ndim != 3:
        raise ValueError(f"need (H, W, B) cube, got {cube.shape}")
    h, w, b = cube.shape
    wl = (np.asarray(wavelengths_nm, dtype=np.float64)
          if wavelengths_nm is not None else np.arange(b, dtype=np.float64))
    ri = _subsample_axis(h, max_size)
    ci = _subsample_axis(w, max_size)
    bi = _subsample_axis(b, max_bands)
    sub = cube[np.ix_(ri, ci, bi)].astype(np.float32)
    if nodata is not None:
        sub = np.where(sub == np.float32(nodata), np.nan, sub)
    good = (np.asarray(good_bands, dtype=bool)[bi]
            if good_bands is not None else np.ones(len(bi), dtype=bool))

    los, his = [], []
    q = np.zeros(sub.shape, dtype=np.uint8)
    for k in range(sub.shape[-1]):
        band = sub[..., k]
        finite = band[np.isfinite(band)]
        if finite.size == 0:
            los.append(0.0)
            his.append(1.0)
            continue
        lo, hi = np.percentile(finite, list(stretch))
        if hi <= lo:
            hi = lo + 1e-6
        los.append(float(lo))
        his.append(float(hi))
        scaled = np.clip((band - lo) / (hi - lo), 0.0, 1.0)
        q[..., k] = np.where(np.isfinite(band),
                             np.round(scaled * 254.0) + 1, 0
                             ).astype(np.uint8)  # 0 = nodata sentinel
    return {
        "h": int(len(ri)), "w": int(len(ci)), "b": int(len(bi)),
        "wl": [float(v) for v in wl[bi]],
        "good": [bool(g) for g in good],
        "lo": los, "hi": his,
        "data_b64": base64.b64encode(q.tobytes()).decode("ascii"),
    }


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { font: 13px system-ui, sans-serif; margin: 16px; background: #14161a;
        color: #dfe3e8; }
 h1 { font-size: 16px; font-weight: 600; }
 .row { display: flex; gap: 20px; align-items: flex-start;
        flex-wrap: wrap; }
 canvas { image-rendering: pixelated; border: 1px solid #333;
          background: #000; }
 .panel { max-width: 460px; }
 label { display: inline-block; min-width: 64px; }
 input[type=range] { width: 240px; vertical-align: middle; }
 #readout, #pixinfo { color: #9ecbff; font-variant-numeric: tabular-nums; }
 button { background: #273043; color: #dfe3e8; border: 1px solid #3a4a66;
          border-radius: 4px; padding: 3px 10px; cursor: pointer; }
 button.active { background: #3a5a8c; }
</style></head><body>
<h1>__TITLE__</h1>
<div class="row">
 <div>
  <canvas id="view"></canvas>
  <div>
   <button id="modeBand" class="active">band</button>
   <button id="modeRGB">RGB</button>
   <span id="readout"></span>
  </div>
  <div><label>band</label><input type="range" id="band" min="0" value="0">
  </div>
  <div><label>gamma</label>
   <input type="range" id="gamma" min="30" max="220" value="100"></div>
 </div>
 <div class="panel">
  <canvas id="spec" width="440" height="220"></canvas>
  <div id="pixinfo">click the image to plot a pixel spectrum</div>
 </div>
</div>
<script>
const M = __META__;
const bytes = Uint8Array.from(atob(M.data_b64), c => c.charCodeAt(0));
const {h, w, b} = M;
const view = document.getElementById('view');
view.width = w; view.height = h;
const scale = Math.max(1, Math.min(Math.floor(900 / w),
                                   Math.floor(620 / h)));
view.style.width = (w * scale) + 'px';
view.style.height = (h * scale) + 'px';
const ctx = view.getContext('2d');
const img = ctx.createImageData(w, h);
const bandSlider = document.getElementById('band');
bandSlider.max = b - 1;
const gammaSlider = document.getElementById('gamma');
const readout = document.getElementById('readout');
let mode = 'band';
function nearestBand(nm) {
  let best = 0, d = Infinity;
  for (let k = 0; k < b; k++) {
    const dk = Math.abs(M.wl[k] - nm);
    if (M.good[k] && dk < d) { d = dk; best = k; }
  }
  return best;
}
const rgbIdx = [__RGB_NM__].map(nearestBand);
function px(r, c, k) { return bytes[(r * w + c) * b + k]; }
function lut(gamma) {
  const t = new Uint8Array(256);
  for (let v = 1; v < 256; v++)
    t[v] = Math.round(255 * Math.pow((v - 1) / 254, gamma));
  return t;
}
function render() {
  const g = gammaSlider.value / 100;
  const t = lut(g);
  const k0 = +bandSlider.value;
  const d = img.data;
  for (let r = 0; r < h; r++) for (let c = 0; c < w; c++) {
    const o = (r * w + c) * 4;
    if (mode === 'band') {
      const v = px(r, c, k0);
      d[o] = d[o+1] = d[o+2] = t[v];
      d[o+3] = v === 0 ? 60 : 255;
    } else {
      const vr = px(r, c, rgbIdx[0]), vg = px(r, c, rgbIdx[1]),
            vb = px(r, c, rgbIdx[2]);
      d[o] = t[vr]; d[o+1] = t[vg]; d[o+2] = t[vb];
      d[o+3] = (vr === 0 && vg === 0 && vb === 0) ? 60 : 255;
    }
  }
  ctx.putImageData(img, 0, 0);
  readout.textContent = mode === 'band'
    ? `band ${k0} · ${M.wl[k0].toFixed(1)} nm` +
      (M.good[k0] ? '' : ' (flagged)')
    : `RGB = ${rgbIdx.map(k => M.wl[k].toFixed(0) + ' nm').join(' / ')}`;
}
function phys(r, c, k) {
  const v = px(r, c, k);
  if (v === 0) return null;
  return M.lo[k] + (v - 1) / 254 * (M.hi[k] - M.lo[k]);
}
const spec = document.getElementById('spec');
const sctx = spec.getContext('2d');
function drawSpectrum(r, c) {
  sctx.fillStyle = '#1b1e24';
  sctx.fillRect(0, 0, spec.width, spec.height);
  const vals = [];
  let lo = Infinity, hi = -Infinity;
  for (let k = 0; k < b; k++) {
    const v = M.good[k] ? phys(r, c, k) : null;
    vals.push(v);
    if (v !== null) { lo = Math.min(lo, v); hi = Math.max(hi, v); }
  }
  if (!isFinite(lo)) return;
  if (hi <= lo) hi = lo + 1e-6;
  const wl0 = M.wl[0], wl1 = M.wl[b - 1];
  const X = nm => 40 + (nm - wl0) / (wl1 - wl0) * (spec.width - 50);
  const Y = v => spec.height - 24 -
                 (v - lo) / (hi - lo) * (spec.height - 40);
  sctx.strokeStyle = '#444'; sctx.fillStyle = '#8a93a3';
  sctx.font = '10px system-ui';
  sctx.beginPath();
  sctx.moveTo(40, 8); sctx.lineTo(40, spec.height - 24);
  sctx.lineTo(spec.width - 8, spec.height - 24); sctx.stroke();
  sctx.fillText(hi.toPrecision(3), 2, 14);
  sctx.fillText(lo.toPrecision(3), 2, spec.height - 24);
  sctx.fillText(wl0.toFixed(0) + ' nm', 40, spec.height - 10);
  sctx.fillText(wl1.toFixed(0) + ' nm', spec.width - 60,
                spec.height - 10);
  sctx.strokeStyle = '#9ecbff'; sctx.beginPath();
  let pen = false;
  for (let k = 0; k < b; k++) {
    const v = vals[k];
    if (v === null) { pen = false; continue; }
    const x = X(M.wl[k]), y = Y(v);
    if (pen) sctx.lineTo(x, y); else sctx.moveTo(x, y);
    pen = true;
  }
  sctx.stroke();
  document.getElementById('pixinfo').textContent =
    `pixel (row ${r}, col ${c})`;
}
view.addEventListener('click', e => {
  const rect = view.getBoundingClientRect();
  const c = Math.floor((e.clientX - rect.left) / rect.width * w);
  const r = Math.floor((e.clientY - rect.top) / rect.height * h);
  if (r >= 0 && r < h && c >= 0 && c < w) drawSpectrum(r, c);
});
document.getElementById('modeBand').onclick = e => {
  mode = 'band';
  e.target.classList.add('active');
  document.getElementById('modeRGB').classList.remove('active');
  render();
};
document.getElementById('modeRGB').onclick = e => {
  mode = 'rgb';
  e.target.classList.add('active');
  document.getElementById('modeBand').classList.remove('active');
  render();
};
bandSlider.oninput = render;
gammaSlider.oninput = render;
render();
</script></body></html>
"""


def write_interactive_quicklook(
    cube_hwb: np.ndarray,
    out_html: Union[str, Path],
    wavelengths_nm: Optional[Sequence[float]] = None,
    *,
    title: str = "hyperres quicklook",
    nodata: Optional[float] = None,
    good_bands: Optional[np.ndarray] = None,
    max_size: int = 640,
    max_bands: int = 96,
    stretch: Tuple[float, float] = (2.0, 98.0),
    rgb_nm: Tuple[float, float, float] = _DEFAULT_RGB_NM,
) -> Path:
    """Export the single-file interactive viewer for a cube."""
    payload = prepare_viewer_payload(
        cube_hwb, wavelengths_nm, nodata=nodata, good_bands=good_bands,
        max_size=max_size, max_bands=max_bands, stretch=stretch)
    html = (_HTML_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__META__", json.dumps(payload))
            .replace("__RGB_NM__", ", ".join(f"{v:.1f}" for v in rgb_nm)))
    out_html = Path(out_html)
    out_html.parent.mkdir(parents=True, exist_ok=True)
    out_html.write_text(html)
    return out_html


def quicklook_from_product(
    path: Union[str, Path],
    out_html: Union[str, Path],
    **kwargs,
) -> Path:
    """Viewer straight from a product file: ENVI header (.hdr), GeoTIFF
    cube, or a raw EMIT granule (.nc) — band browsing over whichever
    cube the file holds."""
    p = Path(path)
    # explicit suffixes first: a granule with a same-stem ENVI header
    # sitting next to it must still route to the granule reader
    if p.suffix.lower() != ".nc" and (
            p.suffix.lower() == ".hdr" or p.with_suffix(".hdr").exists()):
        from ..io import envi
        hdr = p if p.suffix.lower() == ".hdr" else p.with_suffix(".hdr")
        r = envi.EnviReader(hdr)
        cube = r.read().astype(np.float32)
        wl = r.wavelengths
        kwargs.setdefault("nodata", r.nodata if r.nodata is not None
                          else -9999.0)
        kwargs.setdefault("title", f"hyperres quicklook — {p.stem}")
        return write_interactive_quicklook(cube, out_html, wl, **kwargs)
    if p.suffix.lower() == ".nc":
        from ..io.granule import EmitGranule
        with EmitGranule(p) as g:
            cube = g.read_cube().astype(np.float32)
            wl = g.wavelengths
            good = g.good_wavelengths
        kwargs.setdefault("nodata", -9999.0)
        kwargs.setdefault("title", f"hyperres quicklook — {p.stem}")
        return write_interactive_quicklook(cube, out_html, wl,
                                           good_bands=good, **kwargs)
    from ..io.tiff import TiffReader
    with TiffReader(p) as t:
        stack = t.read().astype(np.float32)  # (B, H, W)
        nod = t.nodata
    kwargs.setdefault("nodata", nod)
    kwargs.setdefault("title", f"hyperres quicklook — {p.stem}")
    return write_interactive_quicklook(
        np.moveaxis(stack, 0, -1), out_html, None, **kwargs)
