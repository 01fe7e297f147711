"""Device milliseconds of one ``RidgeSpectralSR.fit``: the program's root
span ``sr.fit`` (its CUDA events), the median over the calls of the
traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "sr.fit", "sr.fit")
