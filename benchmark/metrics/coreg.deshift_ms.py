"""Device milliseconds of the span ``coreg.deshift`` in one call of
``coregister_stack``: the shift field, the 16-tap cubic warp of the
stack (``kernels/warp.py`` ``warp_interpolate_chunked``) and the cast to
u16; the program's CUDA events, the median over the calls of the traced
slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "coreg", "coreg.deshift")
