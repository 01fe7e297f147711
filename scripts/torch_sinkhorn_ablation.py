#!/usr/bin/env python3
"""Where the one-pass Sinkhorn kernel's time goes, on one CUDA GPU (H100).

Builds ``hyperres_torch/csrc/sinkhorn_duals.cu`` as it is and in
variants that each drop one part of the work (the source is edited in
memory and built under ``build/sinkhorn_ablation/``; nothing in the
repository changes), then times 100 one-pass sweeps at 5000 x 5000
(``OTConfig().reg``, uniform marginals, seeded samples) through the C
entry point, so that no host synchronisation falls between sweeps, two
rounds in turn, with CUDA events:

- ``no_exp``: the exponential per element (z - rmax is used as E);
- ``no_copy``: the copies of Mr into shared memory (the kernel works on
  whatever the ring holds);
- ``two_read``: the long-rows route's kernels on the same shape, for
  comparison (the two-read design this kernel replaced).

The full kernel is first held bit-equal to the wrapper's result. The
variants compute wrong values and are only timed. Also prints the
wrapper's time per sweep (it reads err once per 10 sweeps) and the bound
(one read of Mr per sweep at 3.35 TB/s). Fails if a text anchor is no
longer in the source. Run from the repository root:

    python3 scripts/torch_sinkhorn_ablation.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hyperres_torch.core.config import OTConfig  # noqa: E402
from hyperres_torch.kernels import _build  # noqa: E402
from hyperres_torch.kernels import sinkhorn_duals as sd  # noqa: E402
from hyperres_torch.kernels.sinkhorn import (  # noqa: E402
    marginal, sqeuclidean_cdist,
)

N = M = 5000
SWEEPS = 100
EXP = """\
          z[r][k] = expf(z[r][k] - mx[r]);   // exp(-inf) = 0 off the row"""
NO_EXP = """\
          z[r][k] = z[r][k] - mx[r];"""
COPY = """\
      copy_span(buf + (q % kStages) * buf_len, Mr + r0 * m, nrows * m);"""
VARIANTS = {"full": (), "no_exp": ((EXP, NO_EXP),),
            "no_copy": ((COPY, ""),)}


def build() -> dict:
    src = (_build.CSRC / "sinkhorn_duals.cu").read_text()
    out = _build.BUILD_DIR.parent / "sinkhorn_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: anchor not in sinkhorn_duals.cu:"
                                 f"\n{old}")
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
    gen = torch.Generator(device=dev).manual_seed(1)
    Xs = torch.rand((N, 3), device=dev, generator=gen)
    Ys = torch.rand((M, 3), device=dev, generator=gen)
    la = torch.log(marginal(None, N, dev))
    lb = torch.log(marginal(None, M, dev))
    Mr = -sqeuclidean_cdist(Xs, Ys) / OTConfig().reg
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    if libs["full"].sinkhorn_device_limits(ctypes.byref(sms),
                                           ctypes.byref(smem)):
        raise SystemExit("sinkhorn_device_limits failed")
    route = sd.sinkhorn_route(N, M, sms.value, smem.value)
    if route.name != sd.ONE_PASS:
        raise SystemExit(f"{N} x {M} does not take the one-pass route")
    partial = torch.empty((route.blocks, M), device=dev)
    chunk_partial = torch.empty((sd._chunks(N, M, dev), M), device=dev)

    def one_pass(lib):
        fn = lib.sinkhorn_duals_onepass_sweeps
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        f, g = torch.zeros(N, device=dev), torch.zeros(M, device=dev)
        err_row, err = torch.empty(N, device=dev), torch.empty((), device=dev)
        rc = fn(Mr.data_ptr(), la.data_ptr(), lb.data_ptr(), f.data_ptr(),
                g.data_ptr(), err_row.data_ptr(), partial.data_ptr(),
                err.data_ptr(), N, M, route.blocks, route.rows_per_block,
                route.group_rows, SWEEPS,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")
        return f, g

    def two_read():
        fn = libs["full"].sinkhorn_duals_sweeps
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        f, g = torch.zeros(N, device=dev), torch.zeros(M, device=dev)
        rmax, u, err_row = (torch.empty(N, device=dev) for _ in range(3))
        err = torch.empty((), device=dev)
        rc = fn(Mr.data_ptr(), la.data_ptr(), lb.data_ptr(), f.data_ptr(),
                g.data_ptr(), rmax.data_ptr(), u.data_ptr(),
                err_row.data_ptr(), chunk_partial.data_ptr(), err.data_ptr(),
                N, M, chunk_partial.shape[0], SWEEPS,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"launch failed: CUDA error {rc}")

    f, g = one_pass(libs["full"])
    wf, wg, _ = sd.sinkhorn_duals(la, lb, Mr, SWEEPS, 0.0)
    same = bool(torch.equal(f, wf) and torch.equal(g, wg))
    print(f"full variant vs the wrapper: bit-equal {same}", flush=True)
    if not same:
        raise SystemExit("the full variant is not the wrapper's kernel")
    runs = {name: (lambda lib=lib: one_pass(lib)) for name, lib in
            libs.items()}
    runs["two_read"] = two_read
    runs["wrapper"] = lambda: sd.sinkhorn_duals(la, lb, Mr, SWEEPS, 0.0)
    times = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(cuda_ms(fn, 3) / SWEEPS * 1e3)
    bound_us = (4.0 * N * M + 8.0 * (N + M)) / 3.35e12 * 1e6
    for name, t in times.items():
        print(f"{name}: {t[0]:.2f} / {t[1]:.2f} us per sweep (bound "
              f"{bound_us:.2f} us)", flush=True)


if __name__ == "__main__":
    main()
