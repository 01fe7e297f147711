"""Device milliseconds of one ``RidgeSpectralSR.fit``: CUDA events around
each call of the traced run's window, the median."""


def read(ctx):
    return ctx.spans.median_device_ms("fit")
