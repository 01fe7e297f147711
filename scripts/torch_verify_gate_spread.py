"""What ``verify_granule``'s fused gate measures at full width, taken apart.

The gate compares the shipped product (two-pass cube, fused engine) with
the exact one (tap-loop cube, phase-wise engine). The two differ in the
cube and in the draw of OT samples (the fused engine draws on the device,
the phase-wise engine with NumPy). For each scene seed this script makes
the full-width scene of ``tests_gpu/fullscale``'s verify check (a 1242 x
1280 x 285 granule and a 9600 px S2 stack), runs both ortho routes, and
prints the PSNR between ``ot_poly`` products that differ in one thing at
a time:

- ``gate``: fused(two-pass cube) vs phases(tap-loop cube), the gate itself;
- ``cube, fused engine``: fused on the two cubes, the same OT seed;
- ``cube, phase-wise engine``: phases on the two cubes;
- ``engine``: fused vs phases on the two-pass cube;
- ``OT seed``: the fused engine on the two-pass cube for other OT seeds.

Run on a machine with one NVIDIA GPU, from the repository's root:

    python3 scripts/torch_verify_gate_spread.py --scene-seeds 0 1 2

It prints the card's name and power limit first; a full-width scene takes
about four minutes.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def psnr_between(a, b) -> float:
    import torch
    both = torch.isfinite(a).all(dim=-1) & torch.isfinite(b).all(dim=-1)
    d = torch.where(both[..., None], a - b, torch.zeros((), device=a.device))
    mse = float(torch.sum(d.double() ** 2) / (both.sum() * a.shape[-1]))
    return float("inf") if mse == 0 else 10.0 * float(np.log10(1.0 / mse))


def main() -> None:
    import torch
    from hyperres_torch.core.config import (
        OrthoConfig, OTConfig, PolyFusionConfig,
    )
    from hyperres_torch.io.tiff import TiffReader
    from hyperres_torch.kernels.stats import cube_psnr_sam
    from hyperres_torch.ortho.pipeline import orthorectify_granule
    from hyperres_torch.pipeline import fuse_pair
    from hyperres_torch.testing.scenes import make_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene-seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--ot-seeds", type=int, nargs="+", default=[1, 2],
                    help="the fused engine's extra OT seeds (beside 0)")
    ap.add_argument("--raw-shape", type=int, nargs=2, default=[1242, 1280])
    ap.add_argument("--bands", type=int, default=285)
    ap.add_argument("--s2-size", type=int, default=9600)
    ap.add_argument("--device", default="cuda:0",
                    help='"cpu" runs a small scene without a card')
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("this script needs an NVIDIA GPU")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    warnings.filterwarnings("ignore", message=".*PARAMETRIC.*")

    for scene_seed in args.scene_seeds:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            sc = make_scene(Path(d) / "scene", raw_shape=tuple(args.raw_shape),
                            n_bands=args.bands, compress_granule=False,
                            s2_size=args.s2_size, seed=scene_seed)
            cubes = {}
            for kernel in ("two_pass", "taploop"):
                res = orthorectify_granule(
                    sc.emit_nc_path, Path(d) / kernel, sc.s2_tif_path,
                    keep_device_cube=True,
                    config=OrthoConfig(save_geotiffs=False, write_xml=False,
                                       warp_kernel=kernel), device=dev)
                cubes[kernel] = res.device_cube.to(dev)
            with TiffReader(sc.s2_tif_path) as t:
                stack, s2_grid, s2_nodata = (t.read().astype(np.float32),
                                             t.grid, t.nodata)
        vf, p_db, _ = (float(v) for v in cube_psnr_sam(
            cubes["two_pass"], cubes["taploop"], fill=-9999.0, erode=2))
        print(f"scene seed {scene_seed}: made and warped in "
              f"{time.perf_counter() - t0:.1f} s; cube "
              f"{tuple(cubes['two_pass'].shape)}, two-pass vs tap-loop "
              f"{p_db:.2f} dB (valid frac {vf:.4f})", flush=True)

        def run(kernel: str, engine: str, ot_seed: int = 0):
            res = fuse_pair(
                cubes[kernel], res_wl, res_grid, stack, s2_grid,
                good_mask=res_good, engine=engine, s2_scale=1e-4,
                s2_nodata=s2_nodata,
                config=PolyFusionConfig(ot=OTConfig(seed=ot_seed)),
                device=dev)
            return torch.from_numpy(res.fused_10m).to(dev)

        res_wl, res_grid, res_good = (res.wavelengths, res.utm_grid,
                                      res.good_mask)
        fa = {0: run("two_pass", "fused")}
        fb = run("taploop", "fused")
        pb = run("taploop", "phases")
        pa = run("two_pass", "phases")
        for s in args.ot_seeds:
            fa[s] = run("two_pass", "fused", s)
        print(f"scene seed {scene_seed}: PSNR (dB) between ot_poly products: "
              f"gate {psnr_between(fa[0], pb):.2f}; cube, fused engine "
              f"{psnr_between(fa[0], fb):.2f}; cube, phase-wise engine "
              f"{psnr_between(pa, pb):.2f}; engine, two-pass cube "
              f"{psnr_between(fa[0], pa):.2f}; engine, tap-loop cube "
              f"{psnr_between(fb, pb):.2f}; OT seed "
              + ", ".join(f"{i} vs {j}: {psnr_between(fa[i], fa[j]):.2f}"
                          for i, j in itertools.combinations(fa, 2))
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        del fa, fb, pa, pb, cubes, stack
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
