"""Seconds of the synced ``eval/local`` span (the per-client battery), per
round over the traced window; nothing where the battery is off."""


def read(ctx):
    return ctx.span_mean("eval/local")
