"""Launches of the resample kernel per call of ``coregister_stack``: the
program's counter ``resample.kernel`` (one per launch of
``csrc/sep_resample.cu``, inside the span ``coreg.resample``), summed over
each call's spans, the mean over the calls of the traced slice. None
where no span of the window holds the counter (a program without the
kernel, or a run on another device)."""

from benchmark.harness.program_spans import calls, mean_count

COUNTER = "resample.kernel"


def read(ctx):
    if not any(COUNTER in r.counts for c in calls(ctx, "coreg") for r in c):
        return None
    return mean_count(ctx, "coreg", COUNTER)
