"""Seconds of the synced ``eval/global`` span (the global model's battery),
per round over the traced window."""


def read(ctx):
    return ctx.span_mean("eval/global")
