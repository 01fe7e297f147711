"""Tie points used per call of ``coregister_stack``: the program's
counter ``coreg.tiepoints`` (the points left after the filters, which
the affine fit uses), summed over each call's spans, the mean over the
calls of the traced slice."""

from benchmark.harness.program_spans import mean_count


def read(ctx):
    return mean_count(ctx, "coreg", "coreg.tiepoints")
