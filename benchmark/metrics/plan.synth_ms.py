"""Device milliseconds of the plan's span ``fused.synth`` in one call of
``FusedOrthoFusionPlan``: the SRF synthesis, the S2 box to 60 m and the
60 m validity (``_synth_and_valid`` and the valid count); the program's
CUDA events, the median over the calls of the traced slice."""

from benchmark.harness.program_spans import median_stage_ms


def read(ctx):
    return median_stage_ms(ctx, "fused", "fused.synth")
