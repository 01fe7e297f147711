"""Device milliseconds of the span ``coreg.filter`` in one call of
``coregister_stack``: the tie-point filters (reliability, max shift,
MAD, the seeded RANSAC) and the affine least squares, on the host; the
program's CUDA events, the median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "coreg", "coreg.filter")
