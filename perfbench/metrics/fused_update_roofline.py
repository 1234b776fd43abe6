"""The fused update kernel's share of its roofline over the traced round:
the least time the bytes its launches need take at the card's memory
bandwidth (counting.update_bytes: valid clients only), over the kernel's
device time from the profiler (``fused_step_update_kernel``, as
csrc/fused_update.cu names it). The kernel is bound by bytes: it does 6
operations a value against 20 bytes."""

KERNEL = "fused_step_update_kernel"


def read(ctx):
    secs, n = ctx.trace.kernel_time(KERNEL)
    if n == 0 or n != len(ctx.update_bytes) or secs <= 0:
        return None
    bound = sum(ctx.update_bytes) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / secs
