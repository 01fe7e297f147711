"""The full-granule scene, made from the seed on the device.

A frozen copy of ``hyperres_torch/testing/bench_scene.generate_scene``
(itself ``bench.py``'s synthetic granule): a 60 m swath 13 degrees off
north in UTM 33N, its geographic ortho grid and 1-based GLT, the 10 m S2
grid over the swath and the S2-anchored UTM 60 m grid; the raw cube is
four smooth abundance fields times four endmember spectra plus sensor
noise, and the S2 B2 / B3 / B4 stack is the same world through the S2A
responses, as uint16 DN (scale 1e-4, nodata 65535).

What differs from the original, and why: the fields and the noise are
made on the card in a few large calls (the original takes about 20 s of
NumPy on the host), and the noise comes from a ``torch.Generator``
seeded with the run's seed. The world itself (the fields' phases and
frequencies) is the original's, from seed 0, in every run, so every
seed gives the program the same work: the same sizes, the same valid
pixels, the same distributions, different noise. The geometry stays on
the host in float64, as in the original.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .geometry import GEOGRAPHIC, Crs, GridSpec, s2_anchored_target_grid
from .spectra import (emit_wavelength_grid, endmember_spectra, s2a_srf,
                      srf_weight_matrix)

#: the world's fields: seed of their phases and frequencies, texture
WORLD_SEED = 0
FREQ_RANGE = (0.15, 0.9)
N_HARMONICS = 4
NOISE_SIGMA = 0.002
S2_NODATA = 65535


def swath_geometry(raw_h: int, raw_w: int) -> Dict[str, object]:
    """The swath's raw pixel centres (``rx``, ``ry``, UTM metres), the
    geographic ortho grid and its 1-based GLT (oh, ow, 2) int32, the 10 m
    S2 grid over the swath and the S2-anchored UTM 60 m grid."""
    utm = Crs("utm", 33, True)
    cx, cy = 450000.0, 5770000.0
    th = np.radians(13.0)
    rows, cols = np.meshgrid(np.arange(raw_h), np.arange(raw_w), indexing="ij")
    u = (cols - raw_w / 2.0) * 60.0
    v = -(rows - raw_h / 2.0) * 60.0
    rx = cx + u * np.cos(th) - v * np.sin(th)
    ry = cy + u * np.sin(th) + v * np.cos(th)

    lon, lat = utm.to_geographic(rx, ry)
    res_x = 60.0 / 111320.0 / np.cos(np.radians(float(lat.mean())))
    res_y = 60.0 / 111320.0
    lon0 = float(lon.min()) - res_x
    lat0 = float(lat.max()) + res_y
    ow = int(np.ceil((float(lon.max()) + res_x - lon0) / res_x))
    oh = int(np.ceil((lat0 - (float(lat.min()) - res_y)) / res_y))
    ortho = GridSpec(GEOGRAPHIC, lon0, lat0, res_x, res_y, ow, oh)

    oxs, oys = ortho.pixel_center_coords()
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

    s2_x0 = np.floor(float(oux.min()) / 60.0) * 60.0
    s2_y0 = np.ceil(float(ouy.max()) / 60.0) * 60.0
    s2_w = int((float(oux.max()) - s2_x0) // 10.0)
    s2_h = int((s2_y0 - float(ouy.min())) // 10.0)
    s2 = GridSpec(utm, float(s2_x0), float(s2_y0), 10.0, 10.0, s2_w, s2_h)
    return {"rx": rx, "ry": ry, "ortho_grid": ortho, "glt": glt,
            "s2_grid": s2, "utm60": s2_anchored_target_grid(ortho, s2)}


def _world_params():
    rng = np.random.default_rng(WORLD_SEED)
    out = []
    for _ in range(4):
        phase = rng.uniform(0, 2 * np.pi, size=N_HARMONICS)
        freq = rng.uniform(FREQ_RANGE[0], FREQ_RANGE[1], size=(N_HARMONICS, 2))
        out.append((phase, freq))
    return out


def abundance_maps(x_m: torch.Tensor, y_m: torch.Tensor) -> torch.Tensor:
    """(..., 4) smooth positive fields summing to 1 over UTM metres
    (float64 tensors), returned as float32."""
    x = x_m / 1000.0
    y = y_m / 1000.0
    fields = []
    for phase, freq in _world_params():
        f = torch.zeros_like(x)
        for p, (fx, fy) in zip(phase, freq):
            f = f + torch.sin(float(fx) * x + float(fy) * y + float(p))
        fields.append(torch.exp(0.8 * f * (4.0 / N_HARMONICS) ** 0.5))
    a = torch.stack(fields, dim=-1)
    return (a / a.sum(dim=-1, keepdim=True)).to(torch.float32)


def granule_scene(raw_h: int, raw_w: int, n_bands: int, seed: int,
                  device: torch.device) -> Dict[str, object]:
    """The scene of one run: ``raw`` (raw_h, raw_w, n_bands) float32 and
    ``s2_dn`` (3, H10, W10) uint16 on ``device``; the host arrays
    ``glt``, ``wavelengths``, ``good_mask``; the grids ``ortho_grid``,
    ``utm60``, ``s2_grid`` (:class:`GridSpec`)."""
    wl, good = emit_wavelength_grid(n_bands)
    spectra = endmember_spectra(wl)
    geo = swath_geometry(raw_h, raw_w)

    def on(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    raw = abundance_maps(on(geo["rx"]), on(geo["ry"])) @ on(spectra,
                                                            torch.float32)
    noise = torch.randn(raw.shape, generator=gen, device=device,
                        dtype=torch.float32)
    raw.add_(noise, alpha=NOISE_SIGMA).clamp_(0.005, 0.95)
    del noise

    s2 = geo["s2_grid"]
    w3 = srf_weight_matrix(wl, s2a_srf(), good)
    band_spec = on((spectra @ w3.astype(np.float64)).astype(np.float32),
                   torch.float32)
    f = 3  # a 30 m lattice refined bilinearly to 10 m: the fields are
    # band-limited far below its Nyquist rate
    cj = np.arange(0, s2.width + f, f)
    ci = np.arange(0, s2.height + f, f)
    CX, CY = np.meshgrid(s2.x0 + (cj + 0.5) * s2.dx, s2.y0 - (ci + 0.5) * s2.dy)
    rgb_c = torch.clamp(abundance_maps(on(CX), on(CY)) @ band_spec, 0.0, 1.0)
    jj = np.arange(s2.width, dtype=np.float64) / f
    j0 = np.floor(jj).astype(np.int64)
    ii = np.arange(s2.height, dtype=np.float64) / f
    i0 = np.floor(ii).astype(np.int64)
    tj = on((jj - j0).astype(np.float32), torch.float32)[None, :, None]
    ti = on((ii - i0).astype(np.float32), torch.float32)[:, None, None]
    i0t, j0t = on(i0, torch.int64), on(j0, torch.int64)
    rows = rgb_c[i0t] * (1.0 - ti) + rgb_c[i0t + 1] * ti
    del rgb_c
    rgb10 = rows[:, j0t] * (1.0 - tj) + rows[:, j0t + 1] * tj
    del rows
    dn = torch.clamp(torch.round(rgb10 * 10000.0), 0, S2_NODATA - 1)
    del rgb10
    s2_dn = dn.to(torch.int32).to(torch.uint16).permute(2, 0, 1).contiguous()
    del dn
    return {"raw": raw, "s2_dn": s2_dn, "glt": geo["glt"],
            "wavelengths": wl, "good_mask": good,
            "ortho_grid": geo["ortho_grid"], "utm60": geo["utm60"],
            "s2_grid": s2}
