"""Device milliseconds of one call of ``orthorectify_cube`` outside its
four stage spans: the root span ``ortho`` less ``ortho.data``,
``ortho.loc``, ``ortho.obs`` and ``ortho.u16``, per call (the program's
CUDA events), the median over the calls of the traced slice. The four
stages and this add up to the root."""

from benchmark.harness.program_spans import median_self_ms


def read(ctx):
    return median_self_ms(ctx, "ortho")
