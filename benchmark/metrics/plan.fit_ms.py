"""Device milliseconds of the plan's span ``fused.fit`` in one call of
``FusedOrthoFusionPlan``: the OT sampling, cost matrix, Sinkhorn,
barycentric map and polynomial fit (the fit branch of ``_fusion_core``);
the program's CUDA events, the median over the calls of the traced
slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "fused", "fused.fit")
