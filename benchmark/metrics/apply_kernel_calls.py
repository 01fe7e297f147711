"""Launches of the 10 m apply kernel per call of ``FusedOrthoFusionPlan``:
the program's counter ``apply.kernel`` (one per launch of
``csrc/upsample_apply.cu``, inside the span ``fused.apply``), summed over
each call's spans, the mean over the calls of the traced slice. None
where no span of the window holds the counter (a program without the
kernel, or a run on another device)."""

from benchmark.harness.program_spans import calls, mean_count

COUNTER = "apply.kernel"


def read(ctx):
    if not any(COUNTER in r.counts for c in calls(ctx, "fused") for r in c):
        return None
    return mean_count(ctx, "fused", COUNTER)
