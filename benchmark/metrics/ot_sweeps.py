"""Sinkhorn sweeps per call of ``FusedOrthoFusionPlan``: the program's
counter ``ot.sweeps`` (``sinkhorn_log``'s iterations, the duals route's
sweeps), summed over each call's spans, the mean over the calls of the
traced slice."""

from benchmark.harness.program_spans import mean_count


def read(ctx):
    return mean_count(ctx, "fused", "ot.sweeps")
