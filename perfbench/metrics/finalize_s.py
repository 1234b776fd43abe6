"""Seconds a round spends in ``round/finalize`` (the wait for the round's
host copy and the recorder's rows), per round over the traced window."""


def read(ctx):
    return ctx.span_mean("round/finalize")
