"""Launches of the quantize kernel per call of ``orthorectify_cube``: the
program's counter ``quantize.kernel`` (one per launch of
``csrc/quantize_u16.cu``, inside the span ``ortho.u16``), summed over each
call's spans, the mean over the calls of the traced slice. None where no
span of the window holds the counter (a program without the counter, or
a run on another device)."""

from benchmark.harness.program_spans import calls, mean_count

COUNTER = "quantize.kernel"


def read(ctx):
    if not any(COUNTER in r.counts for c in calls(ctx, "ortho") for r in c):
        return None
    return mean_count(ctx, "ortho", COUNTER)
