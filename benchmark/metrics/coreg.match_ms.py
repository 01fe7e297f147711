"""Device milliseconds of the span ``coreg.match`` in one call of
``coregister_stack``: the batched cut of every candidate window pair,
the hole fill, the phase correlation (cuFFT) and the one read of the
shifts and reliabilities (``coreg/local.py`` ``coregister_local``); the
program's CUDA events, the median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "coreg", "coreg.match")
