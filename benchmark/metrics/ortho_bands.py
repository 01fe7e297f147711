"""Bands warped per call of ``orthorectify_cube``: the program's counter
``ortho.bands`` (the DATA, LOC and OBS bands of each warp), summed over
each call's spans, the mean over the calls of the traced slice."""

from benchmark.harness.program_spans import mean_count


def read(ctx):
    return mean_count(ctx, "ortho", "ortho.bands")
