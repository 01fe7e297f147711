"""Multi-device demo over a device mesh with the PyTorch port — the torch
form of ``examples/demo_multichip.py``.

    python examples/torch_demo_multichip.py [N_DEVICES] [--device DEV]

The mesh is ``hyperres_torch.parallel``'s single-process one, over
``[DEV] * N_DEVICES``: N logical shards of one card by default
(``--device cpu`` for the CPU; the same ops run unchanged over several
cards given as ``cuda:0``, ``cuda:1``, ...). It exercises the
production shardings:

- data-parallel ridge-SR training (psum of Gram contributions),
- band-sharded SRF synthesis (285-band axis split, psum assembly),
- mesh-wide masked percentiles (psum histograms).

``main`` returns the printed errors.
"""

import argparse
import sys
from pathlib import Path

# allow running straight from a source checkout: python examples/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of every shard (default: the "
                    "current CUDA device)")
    args = ap.parse_args(argv)
    n = args.n

    import numpy as np
    import torch

    from hyperres_torch.core.config import RidgeSRConfig
    from hyperres_torch.device import resolve_device
    from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR
    from hyperres_torch.parallel.mesh import make_mesh
    from hyperres_torch.parallel.ops import (data_parallel_ridge_fit,
                                             sharded_histogram_percentile,
                                             sharded_srf_synthesize)

    device = resolve_device(args.device)
    mesh = make_mesh((n,), ("data",), devices=[device] * n)
    print(f"mesh: {mesh}")
    rng = np.random.default_rng(0)

    # --- data-parallel ridge training matches single-device exactly ----
    N, bx, by = 8192, 4, 32
    X = rng.uniform(0.1, 0.9, (N, bx)).astype(np.float32)
    Y = np.clip(X @ rng.uniform(0.1, 0.6, (bx, by)).astype(np.float32)
                + 0.05, 0.01, 0.95)
    cfg = RidgeSRConfig(degree=2)
    single = RidgeSpectralSR(bx, by, cfg, device=device).fit(X, Y)
    multi = data_parallel_ridge_fit(
        RidgeSpectralSR(bx, by, cfg, device=device), X, Y, mesh)
    err_w = float((single.W - multi.W).abs().max())
    print(f"data-parallel ridge fit: max |ΔW| vs single-device = "
          f"{err_w:.2e}")
    assert err_w < 1e-3

    # --- band-sharded SRF synthesis ------------------------------------
    # the band axis must divide the mesh; production pads 285 -> 288 with
    # zero-weight bands
    B = -(-285 // n) * n
    cube = rng.uniform(0.0, 1.0, (64, 64, B)).astype(np.float32)
    W = rng.uniform(0.0, 0.1, (B, 13)).astype(np.float32)
    got = sharded_srf_synthesize(cube, W, mesh, axis="data").cpu().numpy()
    want = cube.reshape(-1, B) @ W
    err_srf = float(np.abs(got.reshape(-1, 13) - want).max())
    print(f"band-sharded SRF synth: max err = {err_srf:.2e}")

    # --- mesh-wide percentiles ------------------------------------------
    x = rng.normal(size=(1 << 16,)).astype(np.float32)
    qs = sharded_histogram_percentile(
        torch.from_numpy(x), torch.ones(x.shape, dtype=torch.bool),
        [2.0, 98.0], mesh).cpu().numpy()
    ref = np.percentile(x, [2, 98])
    print(f"sharded percentiles: {qs.round(4)} vs numpy {ref.round(4)}")

    print(f"all multi-device paths OK on {n} shards of {device}")
    return {"n": n, "fit_max_abs_dW": err_w, "srf_max_err": err_srf,
            "percentiles": qs.tolist(), "numpy_percentiles": ref.tolist(),
            "percentile_range": float(x.max() - x.min())}


if __name__ == "__main__":
    main()
