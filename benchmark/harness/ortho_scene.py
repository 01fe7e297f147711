"""The ortho export cell's granule, made from the seed on the device.

The granule is the rgb10 scene's (``scene.py``): its swath, geographic
ortho grid, 1-based GLT and S2-anchored UTM 60 m grid, and its raw cube
(the same four abundance fields and spectra, the same noise from the
run's seed), with the products EMIT ships beside a reflectance granule:

- LOC (L1B ``location``): the longitude and latitude of each raw pixel
  centre (the swath's UTM centres through the frozen projection), and an
  elevation of 0-3 km, a smooth field;
- OBS (L1B ``obs``): the 11 geometry bands, each a smooth field over the
  swath inside its physical range (:func:`obs_bands`);
- the L2A mask's 8 bands (float32): flags 0 cloud (where a smooth field
  passes its 90th percentile: ~10 % of the raw pixels), 1 cirrus (~3 %),
  2 water (~5 %), 3 spacecraft (``SPACECRAFT_LINES`` whole scan lines),
  4 dilated cloud (cloud grown by 2 px), 7 the aggregate of flags 0-4,
  and the data bands 5 (AOD, 0.05-0.3) and 6 (water vapour, 0.5-3 g/cm2).

Every field but the raw cube's noise comes from ``WORLD_SEED``, so every
run seed gives the program the same work. Nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .scene import NOISE_SIGMA, abundance_maps, swath_geometry
from .spectra import emit_wavelength_grid, endmember_spectra

WORLD_SEED = 23
SPACECRAFT_LINES = 4
#: (flag band, share of raw pixels) of the flags drawn from fields
FIELD_FLAGS = ((0, 0.10), (1, 0.03), (2, 0.05))


def _waves(x_km: torch.Tensor, y_km: torch.Tensor, rng, n: int = 6,
           wavelength_km=(4.0, 20.0)) -> torch.Tensor:
    """A smooth field of unit scale: ``n`` plane waves of random
    directions, phases and wavelengths in ``wavelength_km``."""
    f = torch.zeros_like(x_km)
    for _ in range(n):
        k = 2.0 * np.pi / rng.uniform(*wavelength_km)
        th, ph = rng.uniform(0.0, 2.0 * np.pi, 2)
        f = f + torch.sin(k * np.cos(th) * x_km + k * np.sin(th) * y_km
                          + ph)
    return f / np.sqrt(n / 2.0)


def obs_bands(u: torch.Tensor, v: torch.Tensor, f1: torch.Tensor,
              f2: torch.Tensor, f3: torch.Tensor) -> torch.Tensor:
    """The 11 OBS bands (H, W, 11) over the swath's across-track ``u``
    and along-track ``v`` (each -1 to 1) and three smooth fields in
    (-1, 1), in EMIT's band order and units."""
    return torch.stack([
        400000.0 + 12000.0 * u * u,          # path length, m
        80.0 + 40.0 * (1.0 + u),             # to-sensor azimuth, deg
        12.0 * torch.sqrt(u * u + 0.01),     # to-sensor zenith, deg
        150.0 + 1.0 * u + 3.0 * v,           # to-sun azimuth, deg
        35.0 + 0.5 * u + 1.5 * v,            # to-sun zenith, deg
        40.0 + 10.0 * u + 2.0 * v,           # solar phase, deg
        10.0 + 8.0 * f1,                     # slope, deg
        180.0 + 150.0 * f2,                  # aspect, deg
        0.75 + 0.2 * f3,                     # cosine(i)
        10.40 + 0.01 * (v + 1.0),            # UTC time, decimal hours
        0.99 + 0.005 * (v + 1.0),            # Earth-sun distance, AU
    ], dim=-1)


def ortho_scene(raw_h: int, raw_w: int, n_bands: int, seed: int,
                device: torch.device) -> Dict[str, object]:
    """The granule of one run: ``raw`` (raw_h, raw_w, n_bands), ``loc``
    (raw_h, raw_w, 3), ``obs`` (raw_h, raw_w, 11) and ``mask`` (raw_h,
    raw_w, 8), float32 on ``device``; the host ``glt`` and the grids
    ``ortho_grid``, ``utm60`` (:class:`GridSpec`)."""
    wl, _ = emit_wavelength_grid(n_bands)
    spectra = endmember_spectra(wl)
    geo = swath_geometry(raw_h, raw_w)

    def on(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    rx, ry = on(geo["rx"]), on(geo["ry"])
    raw = abundance_maps(rx, ry) @ on(spectra, torch.float32)
    noise = torch.randn(raw.shape, generator=gen, device=device,
                        dtype=torch.float32)
    raw.add_(noise, alpha=NOISE_SIGMA).clamp_(0.005, 0.95)
    del noise

    rng = np.random.default_rng(WORLD_SEED)
    xk, yk = rx / 1000.0, ry / 1000.0
    utm = geo["utm60"].crs
    lon, lat = utm.to_geographic(geo["rx"], geo["ry"])
    elev = 1500.0 + 1500.0 * torch.tanh(_waves(xk, yk, rng))
    loc = torch.stack([on(lon), on(lat), elev], dim=-1).to(torch.float32)

    rows = torch.arange(raw_h, dtype=torch.float64, device=device)
    cols = torch.arange(raw_w, dtype=torch.float64, device=device)
    v = ((rows - raw_h / 2.0) / (raw_h / 2.0))[:, None].expand(raw_h, raw_w)
    u = ((cols - raw_w / 2.0) / (raw_w / 2.0))[None, :].expand(raw_h, raw_w)
    f1, f2, f3 = (torch.tanh(_waves(xk, yk, rng)) for _ in range(3))
    obs = obs_bands(u, v, f1, f2, f3).to(torch.float32)

    mask = torch.zeros((raw_h, raw_w, 8), dtype=torch.float32, device=device)
    for band, share in FIELD_FLAGS:
        f = _waves(xk, yk, rng, wavelength_km=(3.0, 15.0))
        mask[..., band] = (f > torch.quantile(f.flatten().float(),
                                              1.0 - share)).float()
    lines = rng.choice(raw_h, size=min(SPACECRAFT_LINES, raw_h),
                       replace=False)
    mask[torch.as_tensor(lines, device=device), :, 3] = 1.0
    cloud = mask[..., 0][None, None]
    mask[..., 4] = torch.nn.functional.max_pool2d(cloud, 5, 1, 2)[0, 0]
    mask[..., 5] = (0.175 + 0.125 * torch.tanh(_waves(xk, yk, rng))).float()
    mask[..., 6] = (1.75 + 1.25 * torch.tanh(_waves(xk, yk, rng))).float()
    mask[..., 7] = (mask[..., :5].amax(dim=-1) > 0).float()
    return {"raw": raw, "loc": loc, "obs": obs, "mask": mask,
            "glt": geo["glt"], "ortho_grid": geo["ortho_grid"],
            "utm60": geo["utm60"]}
