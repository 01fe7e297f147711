"""Device milliseconds of the span ``coreg.resample`` in one call of
``coregister_stack``: the EMIT band's cubic transfer onto the S2 10 m
grid (``kernels/warp.py`` ``resample_to_grid``: two dense products for
the values and the valid mass, and the renormalisation); the program's
CUDA events, the median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "coreg", "coreg.resample")
