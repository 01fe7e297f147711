"""Device milliseconds of the span ``ortho.u16`` in one call of
``orthorectify_cube``: the four u16 quantizations
(``ortho/products.py``, the quantize kernel) with the OBS ranges and
their one read; the program's CUDA events, the median over the calls of
the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "ortho", "ortho.u16")
