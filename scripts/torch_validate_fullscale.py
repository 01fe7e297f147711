#!/usr/bin/env python3
"""Full-granule-scale accuracy validation of the PyTorch / CUDA port on
one card, the counterpart of ``scripts/validate_fullscale.py``: the
PSNR / SAM of the fused GLT + cubic orthowarp product against the
analytic world truth, at real granule scale.

    python scripts/torch_validate_fullscale.py [scale] [--device cpu]

The scene is the JAX script's: raw 1242 x 1280 x 285 at scale 1 with
sensor noise 0.002 (``default_rng(0)``), the truth the noiseless world
mixed at the UTM 60 m pixel centres (on the device), the metrics
``cube_psnr_sam`` over the 2-px eroded interior of the valid mask. Two
warps: ``taploop`` (the exact gathers, no kernel) and ``two_pass`` (the
scanline kernel). The JAX script's third, ``two_pass/pallas_banded``,
is the same kernel in the port (its feasibility test
``banded_spans_ok`` is not ported: the kernel has no window), so it is
not run again. Each must reach PSNR > 30 dB and SAM < 0.05 rad; prints
``PASS`` and exits 0, else exits 1.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N_BANDS = 285
FILL = -9999.0
NOISE = 0.002
PSNR_MIN_DB = 30.0
SAM_MAX_RAD = 0.05
WARPS = ("taploop", "two_pass")


def make_scene(scale: float) -> dict:
    """The noisy raw cube, its geometry and the UTM-centre abundances
    (``scripts/validate_fullscale.py:36-99``), host arrays."""
    from hyperres_torch.kernels.host import (prepare_glt, scanline_cstar,
                                             source_index_field)
    from hyperres_torch.testing.bench_scene import swath_geometry
    from hyperres_torch.testing.scenes import (abundance_maps,
                                               emit_wavelength_grid,
                                               endmember_spectra)

    raw_h = max(64, int(1242 * scale))
    raw_w = max(64, int(1280 * scale))
    rng = np.random.default_rng(0)
    wl, _ = emit_wavelength_grid(N_BANDS)
    spectra = endmember_spectra(wl)
    geo = swath_geometry(raw_h, raw_w)
    a = abundance_maps(geo["rx"], geo["ry"])
    raw = np.clip(a @ spectra + rng.normal(scale=NOISE, size=(
        raw_h, raw_w, N_BANDS)), 0.005, 0.95).astype(np.float32)
    del a
    og, utm60 = geo["ortho_grid"], geo["utm60"]
    flat_idx, valid = prepare_glt(geo["glt"], (raw_h, raw_w))
    wr, wc = source_index_field(og, utm60)
    uxs, uys = utm60.pixel_center_coords()
    UX, UY = np.meshgrid(uxs, uys)
    return {"raw": raw, "flat_idx": flat_idx.astype(np.int64),
            "valid": valid, "wr": wr, "wc": wc,
            "cstar": scanline_cstar(wr, wc, og.height),
            "a_truth": abundance_maps(UX, UY).astype(np.float32),
            "spectra": spectra.astype(np.float32), "utm60": utm60}


def warp(scene_t: dict, kernel: str):
    """The UTM cube of the scene's device tensors by one of WARPS."""
    from hyperres_torch.kernels.warp import (orthowarp_taploop,
                                             orthowarp_two_pass)

    args = [scene_t[k] for k in ("raw", "flat_idx", "valid", "wr", "wc")]
    if kernel == "two_pass":
        return orthowarp_two_pass(*args, scene_t["cstar"], method="cubic",
                                  fill=FILL)
    return orthowarp_taploop(*args, method="cubic", fill=FILL,
                             row_chunks=64)


def validate(scale: float, device=None) -> dict:
    """{warp: valid fraction, PSNR (dB) and SAM (rad) against the world
    truth} for each of WARPS at ``scale``."""
    import torch

    from hyperres_torch.device import resolve_device
    from hyperres_torch.kernels.stats import cube_psnr_sam

    dev = resolve_device(device)
    scene = make_scene(scale)
    raw, utm60 = scene["raw"], scene["utm60"]
    print(f"raw {raw.shape[0]}x{raw.shape[1]}x{N_BANDS}; utm60 "
          f"{utm60.height}x{utm60.width}", flush=True)
    scene_t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in scene.items() if isinstance(v, np.ndarray)}
    truth = torch.clamp(scene_t.pop("a_truth") @ scene_t.pop("spectra"),
                        0.005, 0.95)
    noise_floor_db = 10 * np.log10(1.0 / NOISE ** 2)
    results = {}
    for kernel in WARPS:
        t0 = time.perf_counter()
        cube = warp(scene_t, kernel)
        vf, p, s = (float(x) for x in cube_psnr_sam(cube, truth, fill=FILL,
                                                    erode=2))
        del cube
        print(f"{kernel} orthowarp+metrics (incl. build): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        print(f"{kernel}: valid fraction {vf:.3f}; "
              f"PSNR vs world truth {p:.2f} dB "
              f"(sensor-noise ceiling ~{noise_floor_db:.1f} dB); "
              f"SAM {s:.5f} rad", flush=True)
        results[kernel] = {"valid_fraction": vf, "psnr_db": p, "sam_rad": s}
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", nargs="?", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    results = validate(args.scale, args.device)
    if not all(r["psnr_db"] > PSNR_MIN_DB and r["sam_rad"] < SAM_MAX_RAD
               for r in results.values()):
        print(f"FAIL: PSNR > {PSNR_MIN_DB} dB and SAM < {SAM_MAX_RAD} rad "
              f"not met: {results}", flush=True)
        raise SystemExit(1)
    print("PASS", flush=True)
    return results


if __name__ == "__main__":
    main()
