"""Device milliseconds of the plan's span ``fused.apply`` in one call of
``FusedOrthoFusionPlan``: the 60 m matched RGB, the 10 m upsample, the
polynomial apply and the mask (the rest of ``_fusion_core``); the
program's CUDA events, the median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "fused", "fused.apply")
