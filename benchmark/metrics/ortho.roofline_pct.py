"""Share of its roofline that one ``orthorectify_cube`` call reaches: the
least time the call needs over its device time (the program's root span
``ortho``, CUDA events, median over the calls of the traced slice), in %.

The least time counts the work the export needs from its shapes, with no
regard to which kernels do it:

- bytes: the raw DATA, LOC and OBS cubes read once, their UTM cubes
  written once (float32), and the u16 codes of the four products (DATA,
  its diagnostic band, LOC, OBS) written once;
- operations: per band, two passes of 4 taps (one multiply-add each),
  the first over the ortho rows x UTM columns, the second over the UTM
  grid.

Peaks: 3.35 TB/s and 67 TFLOP/s float32 (TF32 off).
"""

import statistics

from benchmark.harness.peaks import PEAK_F32_FLOPS, bound, roofline_pct
from benchmark.harness.program_spans import calls


def counts(shapes):
    h, w, b = shapes["raw_hwb"]
    oh, _ = shapes["ortho_hw"]
    hd, wd = shapes["utm_hw"]
    bands = b + shapes["loc_bands"] + shapes["obs_bands"]
    n_bytes = (4.0 * h * w * bands + 4.0 * hd * wd * bands
               + 2.0 * hd * wd * (bands + 1))
    flops = 2.0 * 4 * (oh * wd + hd * wd) * bands
    return n_bytes, flops


def read(ctx):
    ms = [next(r for r in c if r.parent_id is None).ms
          for c in calls(ctx, "ortho")]
    if not ms:
        return None
    n_bytes, flops = counts(ctx.shapes)
    return roofline_pct("ortho", bound(n_bytes, flops, PEAK_F32_FLOPS),
                        statistics.median(ms) / 1e3, ctx.power_limit_w,
                        ctx.log)
