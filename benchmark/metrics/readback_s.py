"""Seconds of reading the products back to host memory (``fused_10m``
``.cpu()``): the host clock around it, the mean over the traced run's
window."""


def read(ctx):
    return ctx.spans.mean_seconds("readback")
