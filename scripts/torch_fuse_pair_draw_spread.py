"""How far two ``ot_poly`` products of the PyTorch port lie apart when only
the draw of OT samples differs.

``fuse_pair``'s OT fit draws 5000 of the valid 60 m pixels: the fused
engine on the device (with the plan's ``torch.Generator``), the
phase-wise engine with NumPy. On the bench scene at ``scale`` (default
0.25: a 380 x 387 x 285 UTM cube and a 2287 x 2324 px S2 stack) this
script runs the port's ``fuse_pair`` on one UTM cube for OT seeds 0-3
(fused) and 0-1 (phase-wise) and prints the PSNR between every two
products, then the spread by pair of engines. ``verify_granule``'s fused
gate (40 dB) compares one fused with one phase-wise product.

Run from the repository's root, on the card by default (``--device cpu``
on the CPU, about two minutes):

    python3 scripts/torch_fuse_pair_draw_spread.py [scale] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
import warnings
from pathlib import Path

os.environ.setdefault("HYPERRES_SRF_SOURCE", "parametric")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    """Prints the PSNR (dB) of every two products and returns them as
    ``{(engine, seed, engine, seed): dB}``."""
    from hyperres_torch import pipeline as tpipe
    from hyperres_torch.core.config import OTConfig, PolyFusionConfig
    from hyperres_torch.device import resolve_device
    from hyperres_torch.fusion.fused import FusedOrthoFusionPlan
    from hyperres_torch.spectral.srf_tables import builtin_srf
    from hyperres_torch.testing.bench_scene import generate_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", nargs="?", type=float, default=0.25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    warnings.filterwarnings("ignore")
    sc = generate_scene(args.scale, 0)
    plan = FusedOrthoFusionPlan(
        sc["ortho_grid"], sc["utm60"], sc["s2_grid"], sc["raw"].shape[:2],
        sc["glt"], sc["wavelengths"], sc["good_mask"],
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), device=dev)
    cube = plan.warp(sc["raw"]).cpu().numpy()
    fuse_args = (cube, sc["wavelengths"], sc["utm60"], sc["s2_dn"],
                 sc["s2_grid"])
    kw = dict(good_mask=sc["good_mask"], s2_scale=1e-4, s2_nodata=65535.0)
    print(f"scale {args.scale} on {dev}: UTM cube {cube.shape}, S2 stack "
          f"{sc['s2_dn'].shape}", flush=True)
    products = {}
    for seed, engine in itertools.product(range(4), ("fused", "phases")):
        if engine == "phases" and seed > 1:
            continue
        t0 = time.perf_counter()
        products[(engine, seed)] = tpipe.fuse_pair(
            *fuse_args, engine=engine, device=dev, config=PolyFusionConfig(
                ot=OTConfig(seed=seed)), **kw).fused_10m
        print(f"OT seed {seed}, {engine}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    spread, by_kind = {}, {}
    for a, b in itertools.combinations(products, 2):
        db = round(tpipe.psnr(products[a], products[b]), 2)
        print(a, b, db, flush=True)
        spread[a + b] = db
        by_kind.setdefault(tuple(sorted((a[0], b[0]))), []).append(db)
    for (e1, e2), dbs in sorted(by_kind.items()):
        print(f"{e1} vs {e2}, another draw: min {min(dbs)} dB, max "
              f"{max(dbs)} dB over {len(dbs)} pairs", flush=True)
    return spread


if __name__ == "__main__":
    main()
