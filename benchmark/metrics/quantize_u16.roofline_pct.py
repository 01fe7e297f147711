"""Share of its roofline that the quantize kernel
(``hyperres_torch/kernels/quantize.py``, ``csrc/quantize_u16.cu``)
reaches in the ortho export's four u16 products: the least time of the
four over the kernel's device time per request (``torch.profiler``,
summed over the kernel names below in the traced slice, over its
requests), in %.

Per request, each product's float32 UTM cube read once and its u16 codes
written once: DATA (its bands), its diagnostic band, LOC and OBS; 4
operations per element (subtract, scale, round, clip). Peaks: 3.35 TB/s
and 67 TFLOP/s float32 (the bytes bound it).
"""

from benchmark.harness.peaks import PEAK_F32_FLOPS, bound, roofline_pct

KERNELS = ("quantize_kernel",)


def counts(shapes):
    _, _, b = shapes["raw_hwb"]
    hd, wd = shapes["utm_hw"]
    n = hd * wd * (b + 1 + shapes["loc_bands"] + shapes["obs_bands"])
    return 6.0 * n, 4.0 * n


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(KERNELS)
    if not s:
        return None
    n_bytes, flops = counts(ctx.shapes)
    return roofline_pct("quantize_u16", bound(n_bytes, flops, PEAK_F32_FLOPS),
                        s / ctx.trace.requests, ctx.power_limit_w, ctx.log)
