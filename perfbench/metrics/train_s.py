"""Seconds of the synced ``round/train`` span (every client's local
epochs through the stacked step), per round over the traced window."""


def read(ctx):
    return ctx.span_mean("round/train")
