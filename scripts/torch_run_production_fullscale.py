#!/usr/bin/env python3
"""Full-scale production-path run of the PyTorch / CUDA port on one
card, the counterpart of ``scripts/run_production_fullscale.py``: a
granule-sized scene written to disk, then the complete
``run_pair_pipeline`` with every file product (ENVI cube, GeoTIFFs,
tiles, report).

    python scripts/torch_run_production_fullscale.py [OUT_DIR] [--device cpu]

The scene is ``make_scene``'s at raw 1242 x 1280 x 285 with a 2048 px
S2 stack (uncompressed granule); the pipeline runs with
``TilingConfig(max_black_frac=0.05)``, ``max_tiles=4`` and
``train_sr=True``, as in the JAX script. ``run(out, raw_shape=...,
s2_size=...)`` takes smaller sizes and returns the pipeline's result.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RAW_SHAPE = (1242, 1280)
N_BANDS = 285
S2_SIZE = 2048


def run(out, raw_shape=RAW_SHAPE, s2_size: int = S2_SIZE, device=None):
    """Write the scene under ``out / "scene"`` and run the pipeline into
    ``out / "run"``; prints the JAX script's lines and returns the
    ``PairRunResult``."""
    from hyperres_torch.core.config import TilingConfig
    from hyperres_torch.pipeline import run_pair_pipeline
    from hyperres_torch.testing.scenes import make_scene

    out = Path(out)
    t0 = time.perf_counter()
    print("writing full-scale scene (granule + S2 stack) ...", flush=True)
    scene = make_scene(out / "scene", raw_shape=tuple(raw_shape),
                       n_bands=N_BANDS, s2_size=s2_size,
                       compress_granule=False)
    print(f"scene written in {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    res = run_pair_pipeline(
        scene.emit_nc_path, scene.s2_tif_path, out / "run",
        tiling_config=TilingConfig(max_black_frac=0.05),
        max_tiles=4, train_sr=True, device=device)
    print(f"pipeline total {time.perf_counter() - t0:.1f}s", flush=True)
    print("stage ledger:", res.ortho_info.get("stages"), flush=True)
    print("fusion stages:", res.fusion.info["stages"], flush=True)
    print("tiles:", len(res.tiles),
          "SR R2:", (res.sr_metrics or {}).get("r2_mean"), flush=True)
    print(res.report_path.read_text(), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="prod_run",
                    help="output directory (default: ./prod_run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    return run(args.out, device=args.device)


if __name__ == "__main__":
    main()
