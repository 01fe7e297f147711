"""Device milliseconds of the span ``ortho.data`` in one call of
``orthorectify_cube``: the quality mask folded into the GLT validity and
the DATA cube's GLT gather and two-pass warp (``kernels/warp.py``
``orthowarp_two_pass``); the program's CUDA events, the median over the
calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "ortho", "ortho.data")
