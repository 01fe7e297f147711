#!/usr/bin/env python3
"""Fused orthowarp against the reference-semantics two-step path at
scale, on one card: the counterpart of
``scripts/validate_fused_parity.py`` for the PyTorch / CUDA port.

    python scripts/torch_validate_fused_parity.py [scale] [--device cpu]

At ``scale`` of the granule (default 0.5, raw 621 x 640 x 285, the JAX
script's noiseless scene) the two-step path gathers the ortho cube
through the GLT (``glt_gather``) and warps it onto the UTM 60 m grid
with the cubic tap loop (``warp_interpolate_taploop``, nodata -9999).
Against it, each fused warp: ``taploop`` (``orthowarp_taploop``, the
JAX script's) and ``two_pass`` (``orthowarp_two_pass``, the scanline
kernel). Each must agree on the valid mask at > 0.9999 of the pixels
and to < 1e-4 at the 99.9th percentile of |difference|: the tap loop
where both are valid (the JAX script's test), the two-pass warp over
the 2-px eroded interior of that mask. The JAX script states its
agreement "away from masked borders"; the two passes renormalise the
valid weight mass per scanline, the tap loop over the 2-D taps, so
within two pixels of nodata they differ by up to ~0.1 (0.11 at scale
0.25 on the CPU), as ``chip_smoke.py``'s two-pass check also keeps
those pixels out. Prints ``PASS`` and exits 0, else exits 1.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N_BANDS = 285
FILL = -9999.0
MASK_AGREEMENT_MIN = 0.9999
P999_MAX = 1e-4
#: the warps held to the two-step path, each with the erosion (px) of the
#: jointly valid mask its differences are taken over
WARPS = {"taploop": 0, "two_pass": 2}


def make_scene(scale: float) -> dict:
    """The noiseless raw cube and its warp operands
    (``scripts/validate_fused_parity.py:20-67``), host arrays."""
    from hyperres_torch.kernels.host import (prepare_glt, scanline_cstar,
                                             source_index_field)
    from hyperres_torch.testing.bench_scene import swath_geometry
    from hyperres_torch.testing.scenes import (abundance_maps,
                                               emit_wavelength_grid,
                                               endmember_spectra)

    raw_h, raw_w = int(1242 * scale), int(1280 * scale)
    wl, _ = emit_wavelength_grid(N_BANDS)
    spectra = endmember_spectra(wl)
    geo = swath_geometry(raw_h, raw_w)
    raw = np.clip(abundance_maps(geo["rx"], geo["ry"]) @ spectra,
                  0.005, 0.95).astype(np.float32)
    flat_idx, valid = prepare_glt(geo["glt"], (raw_h, raw_w))
    wr, wc = source_index_field(geo["ortho_grid"], geo["utm60"])
    return {"raw": raw, "flat_idx": flat_idx.astype(np.int64),
            "valid": valid, "wr": wr, "wc": wc,
            "cstar": scanline_cstar(wr, wc, geo["ortho_grid"].height)}


def agreement(fused, two, erode: int = 0) -> dict:
    """The valid-mask agreement of two (H, W, B) cubes and |fused - two|
    over the ``erode``-px interior of the pixels where both are valid
    (max, 99.9th percentile, median)."""
    from hyperres_torch.kernels.stats import erode_mask

    both_valid = erode_mask((fused[..., 0] != FILL) & (two[..., 0] != FILL),
                            erode)
    fused, two = fused.cpu().numpy(), two.cpu().numpy()
    diff = np.abs(fused - two)[both_valid.cpu().numpy()]
    return {"mask_agreement": float(((fused == FILL) == (two == FILL))
                                    .mean()),
            "max": float(diff.max()), "p99_9": float(np.percentile(diff,
                                                                   99.9)),
            "median": float(np.median(diff))}


def compare(scale: float, device=None) -> dict:
    """Each fused warp of WARPS against the two-step path at ``scale``:
    {warp: :func:`agreement`}."""
    import torch

    from hyperres_torch.device import resolve_device
    from hyperres_torch.kernels.glt import glt_gather
    from hyperres_torch.kernels.warp import (orthowarp_taploop,
                                             orthowarp_two_pass,
                                             warp_interpolate_taploop)

    dev = resolve_device(device)
    s = {k: torch.from_numpy(v).to(dev)
         for k, v in make_scene(scale).items()}
    ortho = glt_gather(s["raw"], s["flat_idx"], s["valid"], fill_value=FILL)
    two = warp_interpolate_taploop(ortho, s["wr"], s["wc"], nodata=FILL,
                                   method="cubic", fill=FILL)
    del ortho
    args5 = [s[k] for k in ("raw", "flat_idx", "valid", "wr", "wc")]
    fused = {
        "taploop": lambda: orthowarp_taploop(*args5, method="cubic",
                                             fill=FILL, row_chunks=64),
        "two_pass": lambda: orthowarp_two_pass(*args5, s["cstar"],
                                               method="cubic", fill=FILL),
    }
    results = {}
    for name, erode in WARPS.items():
        r = agreement(fused[name](), two, erode)
        print(f"{name}: shape {tuple(two.shape)}; valid-mask agreement "
              f"{r['mask_agreement']:.6f}", flush=True)
        print(f"{name}: abs diff on mutually valid ({erode}-px interior): "
              f"max {r['max']:.2e}, p99.9 {r['p99_9']:.2e}, median "
              f"{r['median']:.2e}", flush=True)
        results[name] = r
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", nargs="?", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    results = compare(args.scale, args.device)
    if not all(r["mask_agreement"] > MASK_AGREEMENT_MIN
               and r["p99_9"] < P999_MAX for r in results.values()):
        print(f"FAIL: mask agreement > {MASK_AGREEMENT_MIN} and p99.9 < "
              f"{P999_MAX:g} not met: {results}", flush=True)
        raise SystemExit(1)
    print("PASS", flush=True)
    return results


if __name__ == "__main__":
    main()
