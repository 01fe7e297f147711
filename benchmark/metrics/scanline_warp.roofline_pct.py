"""Share of its roofline that the scanline kernel
(``hyperres_torch/kernels/banded.py``, ``csrc/scanline_warp.cu``)
reaches in the plan's two-pass warp: the least time of the two passes
over the kernel's device time per request (``torch.profiler``, summed
over the kernel names below in the traced slice, over its requests), in
%.

Per request, two passes at the cell's shapes, each reading its source
and its positions once and writing its output once, float32:

- pass 1: source (oh, ow, B + 1), positions (oh, Wd), output (oh, Wd,
  B + 1);
- pass 2: source (oh, Wd, B + 1), positions (Hd, Wd), output (Hd, Wd,
  B + 1);

and 4 taps, one multiply-add each, per output element. Peaks: 3.35 TB/s
and 67 TFLOP/s float32 (the bytes bound it).
"""

from benchmark.harness.peaks import PEAK_F32_FLOPS, bound, roofline_pct

KERNELS = ("scanline_resample_kernel",)


def counts(shapes):
    _, _, b = shapes["raw_hwb"]
    oh, ow = shapes["ortho_hw"]
    hd, wd = shapes["utm_hw"]
    c = b + 1
    out1, out2 = oh * wd * c, hd * wd * c
    n_bytes = 4.0 * ((oh * ow * c + oh * wd + out1)
                     + (out1 + hd * wd + out2))
    return n_bytes, 8.0 * (out1 + out2)


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(KERNELS)
    if not s:
        return None
    n_bytes, flops = counts(ctx.shapes)
    return roofline_pct("scanline_warp", bound(n_bytes, flops, PEAK_F32_FLOPS),
                        s / ctx.trace.requests, ctx.power_limit_w, ctx.log)
