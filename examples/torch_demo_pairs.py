"""End-to-end demo on a synthetic paired scene with the PyTorch port —
the torch form of ``examples/demo_pairs.py``.

    python examples/torch_demo_pairs.py [OUT_DIR] [--device DEV]
                                        [--no-quicklook]

Fabricates an EMIT granule + S2 stack over a shared analytic world, runs
the full pair pipeline (ortho -> coreg -> OT+poly fusion -> tiling ->
spectral-SR) on the card (``--device cpu`` for the CPU), writes
quicklooks (they need matplotlib; ``--no-quicklook`` skips them), and
prints the key quality numbers. ``main`` returns them.
"""

import argparse
import sys
from pathlib import Path

# allow running straight from a source checkout: python examples/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="demo_out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--no-quicklook", action="store_true",
                    help="skip the PNG quicklooks (they need matplotlib)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    from hyperres_torch.core.config import TilingConfig
    from hyperres_torch.device import resolve_device
    from hyperres_torch.io import envi
    from hyperres_torch.pipeline import psnr, run_pair_pipeline, sam
    from hyperres_torch.testing.scenes import make_scene, truth_reflectance

    device = resolve_device(args.device)
    print(f"device: {device}")
    print("fabricating scene ...")
    scene = make_scene(out / "scene", raw_shape=(120, 132), n_bands=64,
                       s2_size=720)

    print("running pair pipeline ...")
    res = run_pair_pipeline(
        scene.emit_nc_path, scene.s2_tif_path, out / "run",
        tiling_config=TilingConfig(emit_tile_size=20, max_black_frac=0.05),
        max_tiles=8, device=device)

    if not args.no_quicklook:
        from hyperres_torch.viz import (show_emit_rgb_from_envi,
                                        show_side_by_side)
        show_emit_rgb_from_envi(res.ortho_info["outputs"]["data_envi_hdr"],
                                save_path=out / "emit_utm_quicklook.png")
        fused = res.fusion.fused_10m
        show_side_by_side(np.nan_to_num(res.fusion.matched_60m),
                          np.nan_to_num(fused[::6, ::6]),
                          "OT+poly matched @60 m", "fused @10 m (decimated)",
                          save_path=out / "fusion_side_by_side.png")

    # quality vs the analytic world
    r = envi.EnviReader(res.ortho_info["outputs"]["data_envi_hdr"])
    cube = r.read()
    xs, ys = r.grid.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    truth = truth_reflectance(X, Y, scene.spectra, seed=0)
    valid = cube[..., 0] != -9999.0
    numbers = {"ortho_psnr_db": psnr(cube[valid], truth[valid]),
               "ortho_sam_rad": sam(cube[valid], truth[valid]),
               "sr_r2_mean": (res.sr_metrics or {}).get("r2_mean"),
               "n_tiles": len(res.tiles),
               "report": str(res.report_path)}
    print(f"ortho PSNR vs world: {numbers['ortho_psnr_db']:.2f} dB")
    print(f"ortho SAM vs world:  {numbers['ortho_sam_rad']:.4f} rad")
    if res.sr_metrics:
        print(f"spectral-SR mean R2: {numbers['sr_r2_mean']:.4f}")
    print(f"tiles: {numbers['n_tiles']}; report: {res.report_path}")
    print(res.report_path.read_text())
    return numbers


if __name__ == "__main__":
    main()
