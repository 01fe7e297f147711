"""The device's idle share of the traced slice of the window: 100 x (1 -
busy / slice), busy the union of the kernel, copy and set intervals of
the ``torch.profiler`` trace."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
