"""Device milliseconds of one u16 product outside the SR kernel: the
program's root span ``sr.predict`` less its ``sr.predict.kernel``
(the kernel's launch and device work), per call (CUDA events), the
median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_self_ms


def read(ctx):
    return median_self_ms(ctx, "sr.predict")
