"""Seconds of one ``stream_cube_to_device`` of the whole raw cube: the
host clock around the call, ending in a synchronise, the mean over the
traced run's window."""


def read(ctx):
    return ctx.spans.mean_seconds("ingest")
