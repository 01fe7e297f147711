"""Device milliseconds of the span ``ortho.obs`` in one call of
``orthorectify_cube``: the OBS cube's GLT gather and two-pass warp; the
program's CUDA events, the median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "ortho", "ortho.obs")
