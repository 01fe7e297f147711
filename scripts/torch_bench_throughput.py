#!/usr/bin/env python3
"""Sustained multi-granule throughput of the PyTorch / CUDA port, the
counterpart of ``scripts/bench_throughput.py``: several granules back to
back through one per-granule program on one card, each raw cube
ingested through the streamed path (``stream_cube_to_device``: chunked
u16-quantized transfer overlapped with the device-side assembly;
HYPERRES_TP_TRANSFER=f32 for a bit-exact upload, ``u12`` too). Reports
granules per minute, the upload included.

    python scripts/torch_bench_throughput.py [--device cpu]

Environment: HYPERRES_TP_SCALE (default 1.0), HYPERRES_TP_GRANULES
(default 3), HYPERRES_TP_TRANSFER (default u16). The granules are made
before the clock starts (one more than timed: granule 0 is the warm-up,
which also builds the scanline kernel at first use).

The program is the JAX script's, from the port's functions:
``orthowarp_two_pass`` (the scanline kernel), ``srf_synthesize`` (S2A
B2/B3/B4), ``shared_percentile_stretch`` of both sides (channels
reversed), ``sample_valid_pixels_device``, ``ot_barycentric_targets``
under ``OTConfig()``, a degree-4 ``polyfit`` per channel,
``separable_resample_matmul`` to 10 m and ``polyval_channels``. Prints
the JAX script's text lines, then a JSON line with ``granules``,
``total_s``, ``granules_per_min``, ``transfer``, ``device`` and
``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N_BANDS = 285
FILL = -9999.0
POLY_DEGREE = 4


def make_context(scale: float, device) -> dict:
    """The granules' shared geometry and the program's device operands
    (``scripts/bench_throughput.py:37-130``): the GLT, index fields and
    scanline positions on the device, the S2A B2/B3/B4 SRF weights, the
    60 m -> 10 m bilinear matrices; and, on the host, what
    :func:`gen_granule` needs."""
    import torch

    from hyperres_torch.kernels.host import (build_srf_weight_matrix,
                                             prepare_glt, scanline_cstar,
                                             separable_index_axes,
                                             separable_weight_matrix,
                                             source_index_field)
    from hyperres_torch.spectral.srf_tables import builtin_srf
    from hyperres_torch.testing.bench_scene import swath_geometry
    from hyperres_torch.testing.scenes import (emit_wavelength_grid,
                                               endmember_spectra)

    raw_h = max(64, int(1242 * scale))
    raw_w = max(64, int(1280 * scale))
    geo = swath_geometry(raw_h, raw_w)
    og, utm60, s2g = geo["ortho_grid"], geo["utm60"], geo["s2_grid"]
    wl, good = emit_wavelength_grid(N_BANDS)
    spectra = endmember_spectra(wl)
    flat_idx, valid = prepare_glt(geo["glt"], (raw_h, raw_w))
    wr, wc = source_index_field(og, utm60)
    cstar = scanline_cstar(wr, wc, og.height)
    sep = separable_index_axes(utm60, s2g)
    W3, _, _ = build_srf_weight_matrix(
        wl, builtin_srf("S2A", bands=["B2", "B3", "B4"]), good)
    uxs, uys = utm60.pixel_center_coords()
    UX, UY = np.meshgrid(uxs, uys)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "device": torch.device(device), "raw_shape": (raw_h, raw_w),
        "rx": geo["rx"], "ry": geo["ry"], "UX": UX, "UY": UY,
        "spectra": spectra, "W3": np.asarray(W3, np.float32),
        "flat_idx": on(flat_idx.astype(np.int64)), "valid": on(valid),
        "wr": on(wr.astype(np.float32)), "wc": on(wc.astype(np.float32)),
        "cstar": on(cstar.astype(np.float32)),
        "Wsrf": on(np.asarray(W3, np.float32)),
        "Wr10": on(separable_weight_matrix(sep[0], utm60.height,
                                           "bilinear").astype(np.float32)),
        "Wc10": on(separable_weight_matrix(sep[1], utm60.width,
                                           "bilinear").astype(np.float32)),
    }


def gen_granule(ctx: dict, seed: int):
    """Granule ``seed``'s raw (h, w, 285) cube and its 60 m S2 RGB on the
    UTM grid (``scripts/bench_throughput.py:102-108``), f32 host arrays."""
    from hyperres_torch.testing.scenes import abundance_maps

    a = abundance_maps(ctx["rx"], ctx["ry"], seed=seed)
    raw = np.clip(a @ ctx["spectra"], 0.005, 0.95).astype(np.float32)
    a60 = abundance_maps(ctx["UX"], ctx["UY"], seed=seed)
    s2rgb = np.clip(a60 @ (ctx["spectra"] @ ctx["W3"]), 0, 1).astype(
        np.float32)
    return raw, s2rgb


def granule_program(ctx: dict, raw, s2rgb, generator) -> dict:
    """One granule through the program (``scripts/bench_throughput.py:
    112-138``) on the device-resident raw cube and S2 RGB. Returns the
    stages: ``utm_cube``, ``synth``, ``sim_n``, ``ref_n``, ``coeffs``,
    ``fused`` and the ``sanity`` scalar (the product's nanmean)."""
    import torch

    from hyperres_torch.core.config import OTConfig
    from hyperres_torch.fusion.sampling import sample_valid_pixels_device
    from hyperres_torch.kernels.lstsq import polyfit, polyval_channels
    from hyperres_torch.kernels.sinkhorn import ot_barycentric_targets
    from hyperres_torch.kernels.srf import srf_synthesize
    from hyperres_torch.kernels.stats import shared_percentile_stretch
    from hyperres_torch.kernels.warp import (orthowarp_two_pass,
                                             separable_resample_matmul)

    ot_cfg = OTConfig()
    utm_cube = orthowarp_two_pass(raw, ctx["flat_idx"], ctx["valid"],
                                  ctx["wr"], ctx["wc"], ctx["cstar"],
                                  method="cubic", fill=FILL)
    synth = srf_synthesize(utm_cube, ctx["Wsrf"])
    valid60 = utm_cube[..., 0] != FILL
    sim_n = shared_percentile_stretch(synth.flip(-1), valid60)
    ref_n = shared_percentile_stretch(s2rgb.flip(-1), valid60)
    Xs, _ = sample_valid_pixels_device(sim_n, valid60, ot_cfg.n_samples,
                                       generator)
    Ys, _ = sample_valid_pixels_device(ref_n, valid60, ot_cfg.n_samples,
                                       generator)
    Ybar = ot_barycentric_targets(Xs, Ys, reg=ot_cfg.reg,
                                  num_itermax=ot_cfg.num_itermax,
                                  stop_thr=ot_cfg.stop_thr)
    coeffs = torch.stack([polyfit(Xs[:, c], Ybar[:, c], POLY_DEGREE)
                          for c in range(3)])
    sim10 = separable_resample_matmul(sim_n, ctx["Wr10"], ctx["Wc10"],
                                      fill=float("nan"))
    fused = torch.clamp(polyval_channels(coeffs, sim10), 0.0, 1.0)
    return {"utm_cube": utm_cube, "synth": synth, "sim_n": sim_n,
            "ref_n": ref_n, "coeffs": coeffs, "fused": fused,
            "sanity": torch.nanmean(fused)}


def upload(ctx: dict, raw: np.ndarray, transfer: str):
    from hyperres_torch.io.ingest import stream_cube_to_device

    return stream_cube_to_device(lambda b0, b1: raw[..., b0:b1], raw.shape,
                                 transfer=transfer, device=ctx["device"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from hyperres_torch.device import resolve_device
    from hyperres_torch.utils.profiling import card_info, synchronize

    dev = resolve_device(args.device)
    scale = float(os.environ.get("HYPERRES_TP_SCALE", "1.0"))
    n_granules = int(os.environ.get("HYPERRES_TP_GRANULES", "3"))
    transfer = os.environ.get("HYPERRES_TP_TRANSFER", "u16")
    ctx = make_context(scale, dev)

    def generator(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    print("pre-generating granules ...", flush=True)
    granules = [gen_granule(ctx, i) for i in range(n_granules + 1)]

    raw, s2rgb = granules[0]
    out = granule_program(ctx, upload(ctx, raw, transfer),
                          torch.from_numpy(s2rgb).to(dev), generator(0))
    synchronize(dev)
    del out
    print("warmup done", flush=True)

    t0 = time.perf_counter()
    done = 0
    for raw, s2rgb in granules[1:]:
        t_up0 = time.perf_counter()
        raw_t = upload(ctx, raw, transfer)
        synchronize(dev)
        t_up = time.perf_counter() - t_up0
        out = granule_program(ctx, raw_t, torch.from_numpy(s2rgb).to(dev),
                              generator(done + 1))
        sanity = float(out["sanity"])
        if not np.isfinite(sanity):
            raise RuntimeError(f"granule {done + 1}: the product's nanmean "
                               f"is {sanity}")
        del out, raw_t
        done += 1
        print(f"granule {done} done at {time.perf_counter() - t0:.1f}s "
              f"(ingest {t_up:.1f}s, {transfer})", flush=True)
    total = time.perf_counter() - t0
    print(f"throughput: {done} granules in {total:.1f}s = "
          f"{done / total * 60:.1f} granules/min "
          f"(incl. host->device upload per granule)", flush=True)
    result = {"granules": done, "total_s": total,
              "granules_per_min": done / total * 60, "transfer": transfer,
              **card_info(dev)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
