"""Coregistration demo with the PyTorch port: recover a known synthetic
shift through the full pipeline — the torch form of
``examples/demo_coreg.py``.

    python examples/torch_demo_coreg.py [OUT_DIR] [--device DEV]

Builds a paired scene whose EMIT swath strictly contains the S2 tile
(with the shared broadband albedo texture cross-band phase correlation
locks onto), derives a shifted S2 stack from the EMIT ortho product
(clean cross-resolution geometry), then runs
``run_pair_pipeline(coregister=True)`` on the card (``--device cpu`` for
the CPU) and prints the applied vs recovered shift and the tie-point
ledger. ``main`` returns those numbers.
"""

import argparse
import sys
from pathlib import Path

# allow running straight from a source checkout: python examples/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="demo_coreg_out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    from hyperres_torch.core.config import CoregConfig, TilingConfig
    from hyperres_torch.device import resolve_device
    from hyperres_torch.io import envi
    from hyperres_torch.io.tiff import TiffReader, write_geotiff
    from hyperres_torch.kernels.host import build_srf_weight_matrix
    from hyperres_torch.kernels.warp import resample_to_grid
    from hyperres_torch.ortho.pipeline import orthorectify_granule
    from hyperres_torch.pipeline import run_pair_pipeline
    from hyperres_torch.spectral import builtin_srf
    from hyperres_torch.testing.scenes import S2_CODE_TO_SHORT, make_scene

    device = resolve_device(args.device)
    print(f"device: {device}")
    print("fabricating scene ...")
    scene = make_scene(out / "scene", raw_shape=(100, 100), n_bands=48,
                       s2_size=480, world_albedo_amp=0.35)

    print("ortho product ...")
    ores = orthorectify_granule(scene.emit_nc_path, out / "ortho",
                                scene.s2_tif_path, device=device)
    r = envi.EnviReader(ores.data_envi_bin.with_suffix(".hdr"))
    cube = np.nan_to_num(r.read().astype(np.float32))

    # derive a shifted S2 stack from the product (SRF synth -> 10 m)
    with TiffReader(scene.s2_tif_path) as t:
        s2_grid, descs = t.grid, t.descriptions
    codes = [str(d).split("_")[0] for d in descs]
    srf = builtin_srf("S2A")
    W, _, _ = build_srf_weight_matrix(
        ores.wavelengths,
        {S2_CODE_TO_SHORT[c]: srf[S2_CODE_TO_SHORT[c]] for c in codes})
    pseudo = np.einsum("hwb,bk->khw", cube, np.asarray(W))
    dy, dx = 2.4, -1.7

    def shift_image(img, dy, dx):
        f = np.fft.rfft2(img)
        n, m = img.shape
        fy = np.fft.fftfreq(n)[:, None]
        fx = np.fft.rfftfreq(m)[None, :]
        return np.fft.irfft2(
            f * np.exp(-2j * np.pi * (fy * dy + fx * dx)),
            s=(n, m)).astype(np.float32)

    bands = [shift_image(np.asarray(resample_to_grid(
        pseudo[k], r.grid, s2_grid, method="bilinear",
        nodata=None, fill=0.0, device=device), np.float32), dy, dx)
        for k in range(pseudo.shape[0])]
    stack = np.clip(np.stack(bands) * 10000.0, 0, 65534).astype(np.uint16)
    s2_shifted = out / "s2_shifted.tif"
    write_geotiff(s2_shifted, stack, s2_grid, nodata=65535,
                  descriptions=descs, tiled=True)

    print(f"applied shift: dy={dy} dx={dx} px (10 m)")
    res = run_pair_pipeline(
        scene.emit_nc_path, s2_shifted, out / "run", coregister=True,
        coreg_config=CoregConfig(window_size=(256, 256), grid_res=120,
                                 max_points=16),
        tiling_config=TilingConfig(emit_tile_size=16, max_black_frac=0.2),
        max_tiles=1, train_sr=False, device=device)
    coreg = res.info["coreg"]
    final = coreg["final"]
    print(f"success: {final.get('success')}  band: {final.get('s2_code')}")
    mdy, mdx = final["mean_shift_px"]
    print(f"recovered: dy={mdy:.3f} dx={mdx:.3f} "
          f"(err {abs(mdy - dy):.3f}, {abs(mdx - dx):.3f} px)")
    print(f"tie points used: {final.get('n_tie_points_used')}")
    print(f"report: {res.report_path}")
    return {"applied_px": (dy, dx), "success": final.get("success"),
            "s2_code": final.get("s2_code"),
            "recovered_px": (float(mdy), float(mdx)),
            "n_tie_points_used": final.get("n_tie_points_used"),
            "report": str(res.report_path)}


if __name__ == "__main__":
    main()
