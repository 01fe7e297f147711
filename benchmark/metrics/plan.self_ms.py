"""Device milliseconds of one call of ``FusedOrthoFusionPlan`` outside
its five stage spans: the root span ``fused`` less ``fused.warp``,
``fused.synth``, ``fused.stretch``, ``fused.fit`` and ``fused.apply``,
per call (the program's CUDA events), the median over the calls of the
traced slice. The five stages and this add up to the root."""

from benchmark.harness.program_spans import median_self_ms


def read(ctx):
    return median_self_ms(ctx, "fused")
