"""Device milliseconds of one ``FusedOrthoFusionPlan.__call__``: CUDA
events around each call of the traced run's window, the median."""


def read(ctx):
    return ctx.spans.median_device_ms("plan")
