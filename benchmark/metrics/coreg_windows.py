"""Windows matched per call of ``coregister_stack``: the program's
counter ``coreg.windows`` (candidate windows no more than half holes on
either side), summed over each call's spans, the mean over the calls of
the traced slice."""

from benchmark.harness.program_spans import mean_count


def read(ctx):
    return mean_count(ctx, "coreg", "coreg.windows")
