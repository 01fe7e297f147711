"""Share of its roofline that one ``FusedOrthoFusionPlan.__call__``
reaches: the least time the product needs over the call's device time
(CUDA events, median over the traced window), in %.

The least time counts the work the product needs from its shapes, with
no regard to which kernels do it:

- bytes: each input read once (the raw cube, B float32 per raw pixel;
  the prepared 10 m S2 RGB, 3 float32 per 10 m pixel) and each returned
  tensor written once (``utm_cube`` B float32 per UTM pixel,
  ``matched_60m`` 3 per UTM pixel, ``fused_10m`` 3 per 10 m pixel, the
  3 x 5 coefficients);
- operations: the two cubic scanline passes (4 taps, one multiply-add
  each, on B + 1 channels of every pass output), the SRF synthesis (B x 3
  multiply-adds per UTM pixel), and at 10 m the bilinear transfer (two
  passes of 2 taps on 4 channels: 3 values and the valid mass) and the
  degree-4 polynomial (4 multiply-adds per channel); the transport's
  sweeps are left out, since their number depends on the data.

Peaks: 3.35 TB/s and 67 TFLOP/s float32 (no stage needs the tensor
cores; the bytes bound it by two orders of magnitude in any case).
"""

from benchmark.harness.peaks import PEAK_F32_FLOPS, bound, roofline_pct


def counts(shapes):
    raw_h, raw_w, b = shapes["raw_hwb"]
    oh, _ = shapes["ortho_hw"]
    hd, wd = shapes["utm_hw"]
    h10, w10 = shapes["s2_hw"]
    n_utm, n10 = hd * wd, h10 * w10
    n_bytes = 4.0 * (raw_h * raw_w * b + 3 * n10            # inputs
                     + n_utm * b + 3 * n_utm + 3 * n10 + 15)  # outputs
    flops = (8.0 * (b + 1) * (oh * wd + hd * wd)   # scanline passes
             + 2.0 * b * 3 * n_utm                 # SRF synthesis
             + n10 * (2 * 2 * 2 * 4 + 3 * 8))      # 10 m transfer + apply
    return n_bytes, flops


def read(ctx):
    ms = ctx.spans.median_device_ms("plan")
    if not ms:
        return None
    n_bytes, flops = counts(ctx.shapes)
    return roofline_pct("plan", bound(n_bytes, flops, PEAK_F32_FLOPS),
                        ms / 1e3, ctx.power_limit_w, ctx.log)
