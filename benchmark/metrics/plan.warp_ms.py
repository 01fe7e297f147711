"""Device milliseconds of the plan's span ``fused.warp`` in one call of
``FusedOrthoFusionPlan``: the GLT gather, the warp source extension,
both scanline passes and the renormalisation
(``FusedOrthoFusionPlan.warp``); the program's CUDA events, the median
over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "fused", "fused.warp")
