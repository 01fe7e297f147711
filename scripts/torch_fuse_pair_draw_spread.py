"""How far two ``ot_poly`` products lie apart when only the draw of OT
samples differs, in the JAX package and in the PyTorch port alike (CPU).

``fuse_pair``'s OT fit draws 5000 of the valid 60 m pixels: the fused
engine on the device (JAX's and PyTorch's generators differ), the
phase-wise engine with NumPy (the same draw in both packages). On the
bench scene at ``scale`` (default 0.25: a 380 x 387 x 285 UTM cube and a
2287 x 2324 px S2 stack) this script runs both packages' ``fuse_pair`` on
one UTM cube for OT seeds 0-3 (fused) and 0-1 (phase-wise) and prints the
PSNR between every two products. ``verify_granule``'s fused gate (40 dB)
compares one fused with one phase-wise product.

Run from the repository's root, on the CPU (about three minutes):

    JAX_PLATFORMS=cpu python3 scripts/torch_fuse_pair_draw_spread.py [scale]
"""

from __future__ import annotations

import itertools
import os
import sys
import time
import warnings
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HYPERRES_SRF_SOURCE", "parametric")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    from hyperres import pipeline as jpipe
    from hyperres.core import config as jconfig
    from hyperres_torch import pipeline as tpipe
    from hyperres_torch.core.config import OTConfig, PolyFusionConfig
    from hyperres_torch.fusion.fused import FusedOrthoFusionPlan
    from hyperres_torch.spectral.srf_tables import builtin_srf
    from hyperres_torch.testing.bench_scene import generate_scene

    warnings.filterwarnings("ignore")
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
    sc = generate_scene(scale, 0)
    plan = FusedOrthoFusionPlan(
        sc["ortho_grid"], sc["utm60"], sc["s2_grid"], sc["raw"].shape[:2],
        sc["glt"], sc["wavelengths"], sc["good_mask"],
        srf=builtin_srf("S2A", bands=["B2", "B3", "B4"]), device="cpu")
    cube = plan.warp(sc["raw"]).numpy()
    args = (cube, sc["wavelengths"], sc["utm60"], sc["s2_dn"], sc["s2_grid"])
    kw = dict(good_mask=sc["good_mask"], s2_scale=1e-4, s2_nodata=65535.0)
    print(f"scale {scale}: UTM cube {cube.shape}, S2 stack "
          f"{sc['s2_dn'].shape}", flush=True)
    products = {}
    for seed, engine in itertools.product(range(4), ("fused", "phases")):
        if engine == "phases" and seed > 1:
            continue
        t0 = time.perf_counter()
        products[("jax", engine, seed)] = jpipe.fuse_pair(
            *args, engine=engine, config=jconfig.PolyFusionConfig(
                ot=jconfig.OTConfig(seed=seed)), **kw).fused_10m
        products[("torch", engine, seed)] = tpipe.fuse_pair(
            *args, engine=engine, device="cpu", config=PolyFusionConfig(
                ot=OTConfig(seed=seed)), **kw).fused_10m
        print(f"OT seed {seed}, {engine}: both packages in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    by_kind = {}
    for a, b in itertools.combinations(products, 2):
        db = round(tpipe.psnr(products[a], products[b]), 2)
        print(a, b, db, flush=True)
        if a[0] == b[0] and (a[1], a[2]) != (b[1], b[2]):
            by_kind.setdefault((a[0], a[1], b[1]), []).append(db)
    for (pkg, e1, e2), dbs in sorted(by_kind.items()):
        print(f"{pkg}: {e1} vs {e2}, another draw: min {min(dbs)} dB, max "
              f"{max(dbs)} dB over {len(dbs)} pairs", flush=True)


if __name__ == "__main__":
    main()
