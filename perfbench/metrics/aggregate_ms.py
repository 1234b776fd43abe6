"""Milliseconds of the synced ``round/aggregate`` span (the server rule over
the stacked deltas), per round over the traced window."""


def read(ctx):
    s = ctx.span_mean("round/aggregate")
    return None if s is None else 1e3 * s
