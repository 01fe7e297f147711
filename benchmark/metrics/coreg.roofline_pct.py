"""Share of its roofline that one ``coregister_stack`` call reaches: the
least time the call needs over its device time (the program's root span
``coreg``, CUDA events, median over the calls of the traced slice), in %.

The least time counts the work the call needs from its shapes, with no
regard to which kernels do it:

- bytes: the S2 stack read once and the product written once, as u16;
  the EMIT band read once (float32); the 10 m reference band (the EMIT
  band on the S2 grid) written once (float32);
- operations: the resample as two 4-tap passes (one multiply-add each;
  the first over the 10 m rows x 60 m columns, the second over the 10 m
  grid), the deshift as 16 taps per band per pixel, and 2 x 5 N log2 N
  per candidate window (N its pixels) for the transforms.

Peaks: 3.35 TB/s and 67 TFLOP/s float32 (TF32 off).
"""

import math
import statistics

from benchmark.harness.peaks import PEAK_F32_FLOPS, bound, roofline_pct
from benchmark.harness.program_spans import calls


def counts(shapes):
    h, w = shapes["s2_hw"]
    h60, w60 = shapes["utm_hw"]
    b = shapes["bands"]
    wy, wx = shapes["window_hw"]
    n10, n_win = h * w, wy * wx
    n_bytes = 2.0 * b * n10 * 2 + 4.0 * h60 * w60 + 4.0 * n10
    flops = (2.0 * 4 * (h * w60 + n10)                     # resample
             + 2.0 * 16 * b * n10                          # deshift
             + shapes["windows"] * 2 * 5.0 * n_win * math.log2(n_win))
    return n_bytes, flops


def read(ctx):
    ms = [next(r for r in c if r.parent_id is None).ms
          for c in calls(ctx, "coreg")]
    if not ms:
        return None
    n_bytes, flops = counts(ctx.shapes)
    return roofline_pct("coreg", bound(n_bytes, flops, PEAK_F32_FLOPS),
                        statistics.median(ms) / 1e3, ctx.power_limit_w,
                        ctx.log)
