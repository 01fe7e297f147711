"""Spectral super-resolution training demo with the PyTorch port — the
torch form of ``examples/demo_spectral_sr.py``: pair multispectral
inputs with hyperspectral targets, train the logit-space standardise ->
poly(3) -> ridge model on the card (``--device cpu`` for the CPU),
report per-band R²/RMSE, and round-trip the fitted parameters.

    python examples/torch_demo_spectral_sr.py [OUT_DIR] [--device DEV]

Everything is synthetic with analytic ground truth, so the printed
metrics are a real accuracy check, not a smoke test: the multispectral
inputs are SRF band integrals of the same spectra the model must
reconstruct. ``main`` returns the printed numbers.
"""

import argparse
import sys
from pathlib import Path

# allow running straight from a source checkout: python examples/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="demo_sr_out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import torch

    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.device import resolve_device
    from hyperres_torch.fusion.ridge_sr import (RidgeSpectralSR, load_params,
                                                save_params)
    from hyperres_torch.kernels.host import build_box_weight_matrix
    from hyperres_torch.kernels.lstsq import r2_rmse_per_band
    from hyperres_torch.testing.scenes import (emit_wavelength_grid,
                                               endmember_spectra,
                                               truth_reflectance)

    device = resolve_device(args.device)
    print(f"device: {device}")
    n_bands = 200  # box windows need the band pitch finer than their width
    wl, fwhm = emit_wavelength_grid(n_bands)
    spectra = endmember_spectra(wl)

    # Hyperspectral targets at random world points + their 4-band
    # multispectral view (box SRF integrals — what Sentinel-2 measures).
    rng = np.random.default_rng(0)
    pts = rng.uniform(200.0, 5800.0, size=(20_000, 2)).astype(np.float64)
    emit = truth_reflectance(pts[:, 0], pts[:, 1], spectra, noise=0.002)
    bands = {"B2": (490.0, 65.0), "B3": (560.0, 35.0),
             "B4": (665.0, 30.0), "B8": (842.0, 115.0)}  # (centre, width) nm
    Wm, names, valid = build_box_weight_matrix(wl, bands)
    assert valid.all(), dict(zip(names, valid))
    emit_t = torch.from_numpy(emit).to(device)
    s2_t = emit_t @ torch.from_numpy(Wm.astype(np.float32)).to(device)

    cfg = RidgeSRConfig()
    model = RidgeSpectralSR(s2_t.shape[1], n_bands, cfg, device=device)
    print(f"training ridge SR ({s2_t.shape[1]} -> {n_bands} bands, "
          f"degree {cfg.degree}, alpha {cfg.alpha}) on 16,000 px ...")
    model.fit(s2_t[:16_000], emit_t[:16_000])

    pred = model.predict(s2_t[16_000:])
    r2, rmse = r2_rmse_per_band(emit_t[16_000:], pred)
    r2, rmse = r2.cpu().numpy(), rmse.cpu().numpy()
    print(f"held-out per-band R²: median {np.median(r2):.4f} "
          f"min {r2.min():.4f}")
    print(f"held-out per-band RMSE: median {np.median(rmse):.5f}")

    # Full-cube inference, batched like Spectral_matching cell 8.
    cube = s2_t[:256 * 64].reshape(256, 64, -1).permute(2, 0, 1)
    sr_cube = model.predict_cube(cube, batch_pixels=8192)
    print(f"predicted cube: {tuple(cube.shape)} -> {tuple(sr_cube.shape)}")

    # Round-trip the parameters the way batch jobs do.
    save_params(out / "sr_params.npz", model)
    model2 = load_params(out / "sr_params.npz", device=device)
    np.testing.assert_allclose(model2.predict(s2_t[:8]).cpu().numpy(),
                               model.predict(s2_t[:8]).cpu().numpy(),
                               atol=1e-6)
    print(f"params saved + reloaded OK -> {out / 'sr_params.npz'}")
    return {"r2_median": float(np.median(r2)), "r2_min": float(r2.min()),
            "rmse_median": float(np.median(rmse)),
            "cube_shape": tuple(sr_cube.shape),
            "params": str(out / "sr_params.npz")}


if __name__ == "__main__":
    main()
