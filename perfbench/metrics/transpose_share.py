"""Share of the traced round's kernel time in cuDNN's layout transposes
(``genericTranspose`` kernels, NCHW <-> NHWC around the grouped
convolutions that vmap makes)."""


def read(ctx):
    total, n = ctx.trace.kernel_time(None)
    if n == 0 or total <= 0:
        return None
    part, _ = ctx.trace.kernel_time("genericTranspose")
    return 100.0 * part / total
