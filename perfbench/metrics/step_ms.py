"""Milliseconds of ``round/train`` per fused-update launch: one launch per
stacked step, counted by the program's ``fused_step_update.launches``."""


def read(ctx):
    secs = ctx.span_total("round/train")
    if secs is None or ctx.launches <= 0:
        return None
    return 1e3 * secs / ctx.launches
