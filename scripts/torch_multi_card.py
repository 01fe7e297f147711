#!/usr/bin/env python3
"""Multi-card checks of the port on two or more CUDA GPUs of one host.

- Each of the five kernels launched on tensors on card k >= 1 while the
  calling thread's current card is 0, against its plain version on the
  CPU (the scanline passes, SRF and the Sinkhorn duals to 1e-5 / 1e-4,
  the quantize codes exactly, the SR codes to one step);
- ``sharded_orthowarp_two_pass`` on a mesh of every card against one
  card's ``orthowarp_two_pass`` (bit-equal, one launch of each pass per
  card), the 2-D (row x band) mesh against warp + matmul (1e-4 of
  max(|v|, 1)), ``sharded_sr_predict_u16(engine="pallas")`` against one
  kernel call (bit-equal, one launch per card) and
  ``data_parallel_ridge_fit`` against the single-card fit (W to 1e-6);
- ``BatchPairDriver.run`` with one worker per card on as many small
  ``make_scene`` pairs.

Prints PASS / FAIL per check and exits non-zero on any FAIL. It is the
on-card counterpart of ``tests/test_torch_parallel.py::
test_kernels_launch_on_the_tensors_card``, which needs JAX for its
imports and so runs on no machine with the cards. Run from the
repository root on a host with at least two cards:

    python3 scripts/torch_multi_card.py
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from hyperres_torch import parallel as tpar  # noqa: E402
from hyperres_torch.batch import BatchPairDriver, PairJob  # noqa: E402
from hyperres_torch.core.config import (  # noqa: E402
    RidgeSRConfig, TilingConfig,
)
from hyperres_torch.device import (  # noqa: E402
    launch_counts, reset_launch_counts,
)
from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR  # noqa: E402
from hyperres_torch.kernels import (  # noqa: E402
    _build, banded, quantize, sr_predict, srf,
)
from hyperres_torch.kernels import sinkhorn_duals as sd  # noqa: E402
from hyperres_torch.kernels.host import (  # noqa: E402
    prepare_glt, scanline_cstar,
)
from hyperres_torch.kernels.warp import orthowarp_two_pass  # noqa: E402
from hyperres_torch.parallel.ops import sharded_sr_predict_u16  # noqa: E402
from hyperres_torch.testing.scenes import make_scene  # noqa: E402

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
KERNELS = ["scanline_warp", "sr_predict", "sinkhorn_duals", "quantize_u16",
           "srf_synthesize"]
T = torch.from_numpy
FAILED = []


def check(label: str, cond, extra: str = "") -> None:
    print(("PASS " if cond else "FAIL ") + f"{label} {extra}", flush=True)
    if not cond:
        FAILED.append(label)


def kernels_on(c: torch.device, rng) -> None:
    """The five kernels on tensors on card ``c`` against their plain
    versions on the CPU."""
    src = T(rng.random((40, 30, 5)).astype(np.float32))
    pos1 = T(rng.uniform(-1, 31, (40, 25)).astype(np.float32))
    pos2 = T(rng.uniform(-1, 41, (20, 30)).astype(np.float32))
    for axis, p in ((1, pos1), (0, pos2)):
        got = banded.scanline_resample(src.to(c), p.to(c), axis)
        e = float((got.cpu() - banded.scanline_resample(src, p, axis))
                  .abs().max())
        check(f"scanline axis {axis} on {c}", got.device == c and e <= 1e-5,
              f"{e:.2e}")
    x = T(rng.random((300, 7)).astype(np.float32))
    q = quantize.quantize_u16(x.to(c), 0.0, 1.0, None, 65535)
    check(f"quantize on {c}", torch.equal(
        q.cpu(), quantize.quantize_u16(x, 0.0, 1.0, None, 65535)))
    W = T(rng.random((7, 3)).astype(np.float32))
    v = T(rng.random(300) > 0.2)
    e = float((srf.pallas_srf_synthesize(x.to(c), W.to(c), v.to(c)).cpu()
               - srf.pallas_srf_synthesize(x, W, v)).abs().max())
    check(f"srf on {c}", e <= 1e-5, f"{e:.2e}")
    m = RidgeSpectralSR(4, 6, RidgeSRConfig(degree=2), device="cpu").fit(
        rng.random((2000, 4)).astype(np.float32),
        rng.uniform(0.1, 0.9, (2000, 6)).astype(np.float32))
    X = T(rng.random((512, 4)).astype(np.float32))
    args = (m.x_mean, m.x_std, m.W, m.intercept, m.factors)
    got = sr_predict.sr_predict_u16(X.to(c), *(a.to(c) for a in args),
                                    layout="rowmajor")
    want = sr_predict.sr_predict_u16(X, *args, layout="rowmajor")
    e = int((got.cpu().to(torch.int32) - want.to(torch.int32)).abs().max())
    check(f"sr_predict on {c}", e <= 1, f"{e} steps")
    Mr = -T(rng.random((64, 80)).astype(np.float32))
    la = torch.full((64,), -np.log(64.0))
    lb = torch.full((80,), -np.log(80.0))
    f, g, _ = sd.sinkhorn_duals(la.to(c), lb.to(c), Mr.to(c), 30, 0.0)
    rf, rg, _ = sd.sinkhorn_duals_reference(la, lb, Mr, 30, 0.0)
    e = max(float((f.cpu() - rf).abs().max()),
            float((g.cpu() - rg).abs().max()))
    check(f"sinkhorn on {c}", e <= 1e-4, f"{e:.2e}")


def warp_case(rng):
    """A 400 x 440 x 64 raw cube, a 640 x 480 GLT grid with 5 % holes, a
    sheared monotone rows field onto 640 x 500."""
    raw = rng.random((400, 440, 64)).astype(np.float32)
    ho, wo, hd, wd = 640, 480, 640, 500
    glt = np.zeros((ho, wo, 2), dtype=np.int32)
    vm = rng.random((ho, wo)) > 0.05
    glt[..., 0] = np.where(vm, rng.integers(1, 441, (ho, wo)), 0)
    glt[..., 1] = np.where(vm, rng.integers(1, 401, (ho, wo)), 0)
    flat, valid = prepare_glt(glt, (400, 440))
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.003 * j * r / hd + 0.2).astype(np.float32)
    cols = (j * (wo / wd) + 0.002 * r - 0.1).astype(np.float32)
    return raw, flat, valid, rows, cols, scanline_cstar(rows, cols, ho)


def sharded_ops(n: int, rng) -> None:
    """The sharded ops on a mesh of the n cards against card 0."""
    cards = [f"cuda:{k}" for k in range(n)]
    mesh = tpar.make_mesh(devices=cards)
    case = warp_case(rng)
    reset_launch_counts()
    got = tpar.sharded_orthowarp_two_pass(*case, mesh, halo=8)
    counts = dict(launch_counts)
    want = orthowarp_two_pass(*(T(a).to("cuda:0") for a in case))
    passes = {banded.KERNEL_NAMES[1]: n, banded.KERNEL_NAMES[0]: n}
    check(f"sharded two-pass over {n} cards",
          torch.equal(got, want) and counts == passes,
          f"{float((got - want).abs().max()):.2e} {counts}")
    if n % 2 == 0:
        W = rng.random((64, 13)).astype(np.float32)
        m2 = tpar.make_mesh((n // 2, 2), ("row", "band"), devices=cards)
        got2 = tpar.sharded_orthowarp_srf_2d(*case, W, m2, halo=8)
        ref = (want.reshape(-1, 64) @ T(W).to("cuda:0")).reshape(got2.shape)
        e = float(((got2 - ref).abs() / ref.abs().clamp(min=1.0)).max())
        check(f"2-D mesh {n // 2}x2 over cards", e <= 1e-4, f"{e:.2e}")
    Xt = rng.random((200_000, 10)).astype(np.float32)
    Yt = np.clip(0.15 + 0.5 * Xt[:, :1] + 0.2 * Xt[:, 1:2]
                 + 0.05 * rng.random((200_000, 32)), 0.01,
                 0.99).astype(np.float32)
    cfg = RidgeSRConfig(degree=3)
    model = RidgeSpectralSR(10, 32, cfg, device="cuda:0").fit(Xt, Yt)
    N = n * 1_500_000
    X = torch.rand((N, 10), device="cuda:0")
    ok = torch.rand(N, device="cuda:0") > 0.1
    reset_launch_counts()
    got = sharded_sr_predict_u16(model, X, ok, mesh, engine="pallas")
    counts = dict(launch_counts)
    want = sr_predict.sr_predict_u16(X, model.x_mean, model.x_std, model.W,
                                     model.intercept, model.factors,
                                     layout="rowmajor", valid=ok)
    same = bool((got.view(torch.int16) == want.view(torch.int16)).all())
    check(f"sharded SR over {n} cards",
          same and counts == {sr_predict.KERNEL_NAME: n}, str(counts))
    multi = tpar.data_parallel_ridge_fit(
        RidgeSpectralSR(10, 32, cfg, device="cuda:0"), Xt, Yt, mesh)
    e = float((multi.W - model.W).abs().max())
    check(f"data-parallel fit over {n} cards", e <= 1e-6, f"{e:.2e}")


def batch_on(n: int) -> None:
    """One batch worker per card, from a thread whose card is 0."""
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        scenes = [make_scene(d / f"s{i}", raw_shape=(96, 100), n_bands=64,
                             s2_size=600, seed=i, compress_granule=False)
                  for i in range(n)]
        jobs = [PairJob(f"p{i}", str(s.emit_nc_path), str(s.s2_tif_path))
                for i, s in enumerate(scenes)]
        drv = BatchPairDriver(d / "out", tiling_config=TilingConfig(
            emit_tile_size=16, max_black_frac=0.5))
        t0 = time.perf_counter()
        man = drv.run(jobs, devices=[f"cuda:{k}" for k in range(n)])
        used = sorted({a["device"] for v in man.values()
                       for a in v["attempts"]})
        check(f"batch on {n} cards",
              all(v["status"] == "done" for v in man.values())
              and len(used) == n,
              f"{time.perf_counter() - t0:.1f} s, devices {used}")


def main() -> None:
    print(subprocess.run(CARD_QUERY, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    n = torch.cuda.device_count()
    print(f"cards: {n}", flush=True)
    if n < 2:
        raise SystemExit("needs two or more CUDA devices")
    _build.load_libraries(KERNELS)
    rng = np.random.default_rng(0)
    with torch.cuda.device(0):
        for k in range(1, n):
            kernels_on(torch.device("cuda", k), rng)
        sharded_ops(n, rng)
    batch_on(n)
    print("FAILED: " + ", ".join(FAILED) if FAILED else "all passed",
          flush=True)
    raise SystemExit(1 if FAILED else 0)


if __name__ == "__main__":
    main()
