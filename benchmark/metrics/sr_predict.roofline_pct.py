"""Share of its roofline that the SR product's kernel
(``hyperres_torch/kernels/sr_predict.py``, ``csrc/sr_predict.cu``)
reaches: the least time the u16 product needs over the kernel's device
time per request (``torch.profiler``, summed over the kernel names below
in the traced slice, over its requests), in %.

The work is the product's, whatever computes it: per valid pixel, F
monomials times By outputs, one multiply-add each (2 F By FLOP); per
pixel, Bx float32 read and By uint16 written (40 B and 64 B at 10 -> 32
bands). The peak is the highest data-sheet rate at which an admissible
implementation could run: TF32 on the tensor cores, 495 TFLOP/s. The
product has to hold float32 accuracy (codes within one step of a float32
evaluation), which no single product in a narrower format gives, and a
split product in bf16 needs more than twice the passes of one in TF32,
so bf16's 989 TFLOP/s is no higher bound. Any implementation, the
present three-term TF32 one or a later one, then reads 100 % or less.
"""

from benchmark.harness.peaks import PEAK_TF32_TC_FLOPS, bound, roofline_pct

KERNELS = ("sr_predict_tc_kernel",)


def counts(shapes):
    n_bytes = shapes["px"] * (4.0 * shapes["bands_in"]
                              + 2.0 * shapes["bands_out"])
    flops = 2.0 * shapes["valid_px"] * shapes["features"] * shapes["bands_out"]
    return n_bytes, flops


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(KERNELS)
    if not s:
        return None
    n_bytes, flops = counts(ctx.shapes)
    return roofline_pct("sr_predict", bound(n_bytes, flops, PEAK_TF32_TC_FLOPS),
                        s / ctx.trace.requests, ctx.power_limit_w, ctx.log)
