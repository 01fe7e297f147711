#!/usr/bin/env python3
"""Granule-scale spectral-SR 10 m product benchmark of the PyTorch / CUDA
port, the counterpart of ``scripts/bench_sr_granule.py``: the u16 SR
product at the full 9140 x 9309 x (10 -> 32) scale on one card, with
px/s and end-to-end seconds.

    python scripts/torch_bench_sr_granule.py [--scale 1.0] [--batch 200000]
        [--params ckpt.npz] [--device cpu]

The model is the JAX script's: degree-3 ridge in logit space from 10 S2
bands to 32 EMIT bands, fitted on 200k synthetic training pixels from
``default_rng(0)``; the input is a seeded (10, H, W) f32 cube whose first
n // 20 pixels (in row-major pixel order) are a nodata stripe (-9999).
Each leg is timed once: the fit, the host input, the upload, the
warm-up call (which builds the kernel with nvcc at first use), the
device program (CUDA events around one call, then a synchronise) and
the readback of the u16 product.

The timed program is ``RidgeSpectralSR.predict_cube_u16`` in the
``"cmajor"`` layout (``hyperres_torch/fusion/ridge_sr.py:340``), the
port's serving form that launches the SR kernel once for the cube; the
reference's ``_predict_quant_batches`` (a fori_loop over ``--batch``
pixels, ``hyperres/fusion/ridge_sr.py:184``) has no counterpart in the
port (its plain-op form is the ``"xla"`` engine, which takes
``--batch`` as its batch size). Prints a JSON line last, with the JAX
script's keys plus ``device`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BANDS_IN, BANDS_OUT, DEGREE = 10, 32, 3
FULL_HW = (9140, 9309)
N_TRAIN = 200_000
NODATA = -9999.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def training_data(rng, n: int = N_TRAIN, bx: int = BANDS_IN,
                  by: int = BANDS_OUT):
    """The synthetic correlated training pixels
    (``scripts/bench_sr_granule.py:56-62``): X (n, bx), Y (n, by) f32."""
    X = rng.random((n, bx)).astype(np.float32)
    Y = np.clip(0.15 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2]
                + 0.05 * rng.random((n, by)), 0.01, 0.99).astype(np.float32)
    return X, Y


def granule_shape(scale: float) -> tuple:
    return (max(64, int(FULL_HW[0] * scale)),
            max(64, int(FULL_HW[1] * scale)))


def granule_cube(rng, h: int, w: int, bx: int = BANDS_IN) -> np.ndarray:
    """The (bx, h, w) f32 input: uniform reflectances with the first
    ``h * w // 20`` pixels (row-major) set to NODATA in every band."""
    cube = rng.random((bx, h, w), dtype=np.float32)
    cube.reshape(bx, h * w)[:, :h * w // 20] = NODATA
    return cube


def fit_model(X, Y, batch: int, params=None, device=None):
    """(model, fit seconds): the degree-3 model fitted on (X, Y), or
    loaded from the ``params`` checkpoint where that file exists (and
    saved there after a fit)."""
    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.fusion.ridge_sr import (RidgeSpectralSR, load_params,
                                                save_params)
    from hyperres_torch.utils.profiling import synchronize

    if params and Path(params).exists():
        log(f"loaded params from {params}")
        return load_params(params, device=device), 0.0
    t0 = time.perf_counter()
    model = RidgeSpectralSR(X.shape[1], Y.shape[1],
                            RidgeSRConfig(degree=DEGREE, batch_pixels=batch),
                            device=device).fit(X, Y)
    synchronize(model.device)
    t_fit = time.perf_counter() - t0
    if params:
        save_params(params, model)
    return model, t_fit


def product_legs(model, cube: np.ndarray, readback: bool = True):
    """The product's legs on the model's device: upload the host cube,
    one warm-up call, one timed call (``timed_call``), and the readback
    of its codes where ``readback``. Returns (legs in seconds, the
    device cube, the timed call's (By, H, W) u16 codes on the device,
    the codes on the host or None)."""
    import torch

    from hyperres_torch.utils.profiling import synchronize, timed_call

    dev = model.device
    t0 = time.perf_counter()
    X = torch.from_numpy(cube).to(dev)
    synchronize(dev)
    legs = {"upload_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    q = model.predict_cube_u16(X, nodata=NODATA)
    synchronize(dev)
    legs["compile_s"] = time.perf_counter() - t0
    del q
    q, legs["device_program_s"] = timed_call(
        lambda: model.predict_cube_u16(X, nodata=NODATA), dev)
    q_host = None
    if readback:
        t0 = time.perf_counter()
        q_host = q.cpu().numpy()
        legs["readback_s"] = time.perf_counter() - t0
    return legs, X, q, q_host


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=200_000)
    ap.add_argument("--params", default=None,
                    help="npz checkpoint: load the fitted model if the "
                         "file exists, else fit and save")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from hyperres_torch.device import resolve_device
    from hyperres_torch.utils.profiling import card_info

    dev = resolve_device(args.device)
    card = card_info(dev)
    h, w = granule_shape(args.scale)
    n = h * w
    log(f"device: {dev} ({card['device']}); scene: {BANDS_IN} bands x "
        f"{h}x{w} -> {BANDS_OUT} bands ({n / 1e6:.1f} Mpx)")

    rng = np.random.default_rng(0)
    Xt, Yt = training_data(rng)
    model, t_fit = fit_model(Xt, Yt, args.batch, args.params, dev)
    log(f"fit ({N_TRAIN} px, degree {DEGREE}): {t_fit:.3f}s; "
        f"{model.n_features} features")

    t0 = time.perf_counter()
    cube = granule_cube(rng, h, w)
    t_prep = time.perf_counter() - t0
    log(f"host input ({cube.nbytes / 1e9:.2f} GB): {t_prep:.1f}s")
    legs, X, q, q_host = product_legs(model, cube)
    del X, q
    log(f"upload {legs['upload_s']:.2f}s; warmup incl. build "
        f"{legs['compile_s']:.2f}s; device program "
        f"{legs['device_program_s']:.4f}s; readback "
        f"({q_host.nbytes / 1e9:.2f} GB u16) {legs['readback_s']:.2f}s; "
        f"engine {model.last_engine}")

    n_valid = int((q_host.reshape(BANDS_OUT, n) != 65535).all(0).sum())
    e2e = t_prep + legs["upload_s"] + legs["device_program_s"] \
        + legs["readback_s"]
    out = {
        "metric": "spectral_sr_10m_product",
        "mpx": round(n / 1e6, 2),
        "bands_in": BANDS_IN,
        "bands_out": BANDS_OUT,
        "fit_s": round(t_fit, 3),
        "compile_s": round(legs["compile_s"], 2),
        "device_program_s": legs["device_program_s"],
        "device_px_per_s": round(n / legs["device_program_s"]),
        "upload_s": round(legs["upload_s"], 2),
        "readback_s": round(legs["readback_s"], 2),
        "e2e_s": round(e2e, 2),
        "e2e_px_per_s": round(n / e2e),
        "valid_px": n_valid,
        "batch": args.batch,
        **card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
