"""Fused ortho warps per call of the cell's root: the program's counter
``orthowarp.kernel`` (one per ``orthowarp_two_pass`` that runs the two
fused passes of ``csrc/scanline_warp.cu``, inside the warp's stage span),
summed over each call's spans, the mean over the calls of the traced
slice. The root is the plan's ``fused`` (``rgb10.resident``: one DATA
warp a call) or the ortho export's ``ortho`` (``ortho60.resident``: the
DATA, LOC and OBS warps). None where no span of the window holds the
counter (a program without the fused warp, or a run on another
device)."""

from benchmark.harness.program_spans import calls, mean_count

COUNTER = "orthowarp.kernel"
ROOTS = ("fused", "ortho")


def read(ctx):
    for root in ROOTS:
        if any(COUNTER in r.counts for c in calls(ctx, root) for r in c):
            return mean_count(ctx, root, COUNTER)
    return None
