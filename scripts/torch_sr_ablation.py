#!/usr/bin/env python3
"""Where the SR-predict kernel's time goes, on one CUDA GPU (H100).

Builds ``hyperres_torch/csrc/sr_predict.cu`` as it is and in variants
that each drop one part of the work (the source is edited in memory and
built under ``build/sr_ablation/``; nothing in the repository changes),
then times each at the (10 -> 32, 9140 x 9309) product, two rounds in
turn, with CUDA events:

- ``no_epilogue``: the sigmoid, rint and clip per output (the raw sum
  is stored instead);
- ``no_wgmma``: the tensor-core products (the fragments are folded into
  the accumulators by one integer operation each);
- ``no_forming``: the monomials (the fragments are constants);
- ``no_split``: the TF32 hi / lo rounding (two integer operations stand
  in for five);
- the two pairs ``no_forming_no_epilogue`` and ``no_wgmma_no_epilogue``,
  and ``skeleton`` (none of forming, wgmma and epilogue: the tile loads,
  standardisation, validity, barriers and stores).

Each part's cost is the full kernel's time less its variant's. The
variants compute wrong values and are only timed; the full kernel is
first held to the wrapper's own launch (0 codes may differ). Fails if a
text anchor is no longer in the source. Run from the repository root:

    python3 scripts/torch_sr_ablation.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hyperres_torch.core.config import RidgeSRConfig  # noqa: E402
from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR  # noqa: E402
from hyperres_torch.kernels import _build  # noqa: E402
from hyperres_torch.kernels import sr_predict as sp  # noqa: E402

SHAPE = (10, 9140 * 9309)
EPILOGUE = """\
      float z = ((acc[i] + acc_lo[i]) + acc[i + BN / 2]) + ic[c];
      z = fminf(fmaxf(z, -50.0f), 50.0f);
      const float y = 1.0f / (1.0f + expf(-z));
      const float q = fminf(fmaxf(rintf(y * 10000.0f), 0.0f), 65534.0f);"""
NO_EPILOGUE = """\
      const float q = (acc[i] + acc_lo[i]) + acc[i + BN / 2];"""
WGMMA = """\
        Wgmma<2 * BN>::run(acc, a_hi[s], desc + step);
        Wgmma<BN>::run(acc_lo, a_lo[s], desc + step);"""
NO_WGMMA = """\
        acc[s] += __uint_as_float(a_hi[s][0] ^ a_hi[s][1] ^ a_hi[s][2]
                                  ^ a_hi[s][3]);
        acc_lo[s] += __uint_as_float(a_lo[s][0] ^ a_lo[s][1] ^ a_lo[s][2]
                                     ^ a_lo[s][3]);"""
FORMING = """\
        const uint4 e = load_pair<D>(pair_s, (k0 / 8 + s) * 4 + t);
        // fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        float v[4];
        pair_values<D>(px0, e, v[0], v[2]);
        pair_values<D>(px1, e, v[1], v[3]);"""
NO_FORMING = """\
        float v[4];
        for (int r = 0; r < 4; ++r) {
          v[r] = __uint_as_float(0x3f800000u + (uint32_t)(k0 + s + r));
        }"""
SPLIT = """\
          a_hi[s][r] = tf32_rna(v[r]);
          a_lo[s][r] = tf32_rna(v[r] - __uint_as_float(a_hi[s][r]));"""
NO_SPLIT = """\
          a_hi[s][r] = __float_as_uint(v[r]);
          a_lo[s][r] = __float_as_uint(v[r]) >> 3;"""
VARIANTS = {
    "full": (),
    "no_epilogue": ((EPILOGUE, NO_EPILOGUE),),
    "no_wgmma": ((WGMMA, NO_WGMMA),),
    "no_forming": ((FORMING, NO_FORMING),),
    "no_split": ((SPLIT, NO_SPLIT),),
    "no_forming_no_epilogue": ((FORMING, NO_FORMING),
                               (EPILOGUE, NO_EPILOGUE)),
    "no_wgmma_no_epilogue": ((WGMMA, NO_WGMMA), (EPILOGUE, NO_EPILOGUE)),
    "skeleton": ((FORMING, NO_FORMING), (WGMMA, NO_WGMMA),
                 (EPILOGUE, NO_EPILOGUE)),
}


def build() -> dict:
    """Every variant, one nvcc each, all started together."""
    src = (_build.CSRC / "sr_predict.cu").read_text()
    out = _build.BUILD_DIR.parent / "sr_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: anchor not in sr_predict.cu:\n"
                                 f"{old}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def cuda_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = build()
    rng = np.random.default_rng(0)
    X = rng.random((200_000, 10)).astype(np.float32)
    Y = np.clip(0.15 + 0.5 * X[:, :1] + 0.2 * X[:, 1:2]
                + 0.05 * rng.random((200_000, 32)), 0.01,
                0.99).astype(np.float32)
    m = RidgeSpectralSR(10, 32, RidgeSRConfig(degree=3), device=dev).fit(X, Y)
    pairs, src = sp._device_pairs(m.factors)
    W = m.W.contiguous()
    Xp = torch.rand(SHAPE, device=dev)
    q = torch.empty((32, SHAPE[1]), dtype=torch.uint16, device=dev)

    def launch(lib) -> None:
        fn = lib.sr_predict_u16_f32
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
        rc = fn(Xp.data_ptr(), None, m.x_mean.data_ptr(), m.x_std.data_ptr(),
                W.data_ptr(), m.intercept.data_ptr(), pairs.data_ptr(),
                src.data_ptr(), q.data_ptr(), SHAPE[1], 10, 32,
                pairs.shape[0], 3, 1, SHAPE[1], 1, SHAPE[1], 1, -9999.0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")

    want = sp.sr_predict_u16(Xp, m.x_mean, m.x_std, m.W, m.intercept,
                             m.factors, nodata=-9999.0)
    launch(libs["full"])
    torch.cuda.synchronize()
    n_diff = int((q.to(torch.int32) != want.to(torch.int32)).sum())
    print(f"full variant vs the wrapper: {n_diff} codes differ", flush=True)
    if n_diff:
        raise SystemExit("the full variant is not the wrapper's kernel")
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(cuda_ms(lambda: launch(lib), 3))
    full = min(times["full"])
    for name, t in times.items():
        print(f"{name}: {t[0]:.3f} / {t[1]:.3f} ms (full less this: "
              f"{full - min(t):.3f} ms)", flush=True)


if __name__ == "__main__":
    main()
