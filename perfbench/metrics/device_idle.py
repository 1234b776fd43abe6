"""Share of the profiled round in which no operation ran on the device:
1 - (union of the device intervals) / (the traced window). Taken under
torch.profiler, which lengthens the round on the host and not on the
device, so it reads above the idle share of an unprofiled round (PERF.md,
section 5).
"""

def read(ctx):
    w = ctx.trace.window_s
    if w <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / w)
