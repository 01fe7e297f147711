"""Device milliseconds of the plan's span ``fused.stretch`` in one call of
``FusedOrthoFusionPlan``: both shared percentile stretches, their sorts
and host reads (``_stretch``); the program's CUDA events, the median
over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "fused", "fused.stretch")
