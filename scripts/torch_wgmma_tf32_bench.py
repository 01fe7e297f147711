#!/usr/bin/env python3
"""TF32 ``wgmma`` throughput on one CUDA GPU (H100): what the tensor cores
give the SR-predict kernel's shapes when nothing else runs.

Generates one kernel per variant (a warpgroup per CTA, 128 threads) that
issues ``wgmma.mma_async.m64nNk8.f32.tf32.tf32`` back to back on
accumulators that stay in registers: A from registers (RS, as
``csrc/sr_predict.cu`` does) or from shared memory (SS); one accumulator
chain per listed N; ``steps`` k8 steps per commit group, each group
waited for before the next; 1, 2 or 4 CTAs per SM. The operands are
constants; only the rate is measured. Prints TFLOP/s per variant (dense
peak 495 on an H100 SXM). Builds under ``build/wgmma_bench/``. Run from
the repository root:

    python3 scripts/torch_wgmma_tf32_bench.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hyperres_torch.kernels import _build  # noqa: E402

#: (A from shared memory, N of each accumulator chain, k8 steps per commit)
VARIANTS = [
    (False, (32,), 4), (False, (64,), 4), (False, (64, 64), 4),
    (False, (64, 32), 4), (False, (96,), 4), (False, (128,), 4),
    (False, (64,), 32), (False, (64, 32), 32),
    (True, (64, 32), 4), (True, (128,), 4), (True, (256,), 4),
]
ITERS = 200

HEAD = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
"""


def wgmma_fn(n: int, ss: bool) -> str:
    """``wg_{rs|ss}_{n}(d, a, b)``: one m64n{n}k8 TF32 wgmma."""
    nreg = n // 2
    outs = ", ".join(f"%{i}" for i in range(nreg))
    if ss:
        a_ops, b_op, pred = f"%{nreg}", f"%{nreg + 1}", nreg + 2
        ins, a_decl = '"l"(a), "l"(b), "r"(1)', "uint64_t a"
    else:
        a_ops = "{" + ", ".join(f"%{nreg + i}" for i in range(4)) + "}"
        b_op, pred = f"%{nreg + 4}", nreg + 5
        ins = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)'
        a_decl = "const uint32_t (&a)[4]"
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(nreg))
    return f"""
__device__ __forceinline__ void wg_{'ss' if ss else 'rs'}_{n}(
    float (&d)[{nreg}], {a_decl}, uint64_t b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{pred}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{outs}}}, {a_ops}, {b_op}, p, 1, 1;\\n}}\\n"
      : {cons}
      : {ins});
}}
"""


def kernel(idx: int, ss: bool, ns: tuple, steps: int) -> str:
    """Kernel ``k{idx}`` and its launcher ``run_k{idx}``."""
    nb = max(ns)
    decl = "\n".join(f"  float acc{c}[{n // 2}];" for c, n in enumerate(ns))
    init = "\n".join(f"#pragma unroll\n  for (int i = 0; i < {n // 2}; ++i) "
                     f"acc{c}[i] = 0.0f;" for c, n in enumerate(ns))
    pins = "\n".join(f"#pragma unroll\n      for (int i = 0; i < {n // 2}; "
                     f"++i) pin(acc{c}[i]);" for c, n in enumerate(ns))
    a = "a + (s & 3) * 16" if ss else "a"
    mmas = "\n".join(f"        wg_{'ss' if ss else 'rs'}_{n}(acc{c}, {a}, "
                     f"b + (s & 3) * 16);" for c, n in enumerate(ns))
    total = " + ".join(f"acc{c}[0]" for c in range(len(ns)))
    a_setup = ("const uint64_t a = desc(as_, 128, 8 * 128);" if ss else
               "uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, "
               "0x3f800000u};")
    smem = (nb + 64) * 32 * 4
    return f"""
__global__ void __launch_bounds__(128) k{idx}(float* out, int iters) {{
  extern __shared__ __align__(128) float sm[];
  float* bs = sm;               // {nb} rows x 32 k
  float* as_ = sm + {nb} * 32;  // 64 rows x 32 k
  for (int i = threadIdx.x; i < ({nb} + 64) * 32; i += 128) {{
    sm[i] = 1.0f / (1 + (i & 7));
  }}
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncthreads();
  const uint64_t b = desc(bs, 128, 8 * 128);
  {a_setup}
{decl}
{init}
  for (int it = 0; it < iters; ++it) {{
#pragma unroll
    for (int s0 = 0; s0 < 32; s0 += {steps}) {{
{pins}
      asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
      for (int s = s0; s < s0 + {steps}; ++s) {{
{mmas}
      }}
      asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
{pins}
    }}
  }}
  out[blockIdx.x * 128 + threadIdx.x] = {total};
}}

extern "C" int run_k{idx}(float* out, int iters, int grid, void* st) {{
  cudaFuncSetAttribute(k{idx}, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       {smem});
  k{idx}<<<grid, 128, {smem}, (cudaStream_t)st>>>(out, iters);
  return (int)cudaGetLastError();
}}
"""


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    src = HEAD
    for ss in (False, True):
        for n in sorted({n for s, ns, _ in VARIANTS if s == ss for n in ns}):
            src += wgmma_fn(n, ss)
    for i, v in enumerate(VARIANTS):
        src += kernel(i, *v)
    out = _build.BUILD_DIR.parent / "wgmma_bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bench.cu").write_text(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out / "bench.so"), str(out / "bench.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "bench.so"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 4 * 128, device="cuda")
    for i, (ss, ns, steps) in enumerate(VARIANTS):
        fn = getattr(lib, f"run_k{i}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        rates = []
        for per_sm in (1, 2, 4):
            grid = sms * per_sm

            def go():
                rc = fn(buf.data_ptr(), ITERS, grid,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"launch failed: CUDA error {rc}")
            go()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                go()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            flops = 2.0 * 64 * sum(ns) * 8 * 32 * ITERS * grid
            rates.append(f"{flops / ms / 1e9:.1f}")
        print(f"{'SS' if ss else 'RS'} N={'+'.join(map(str, ns))} "
              f"{steps} k8 steps per commit: TFLOP/s at 1 / 2 / 4 "
              f"warpgroups per SM {' / '.join(rates)}", flush=True)


if __name__ == "__main__":
    main()
