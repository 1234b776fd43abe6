"""The client step's share of the card's peak: the useful FLOPs of the
clients' training (counting.round_flops) over the seconds of the synced
``round/train`` span and the configuration's peak, over the traced
window's untraced rounds."""


def read(ctx):
    secs = ctx.span_total("round/train")
    if not secs or ctx.train_flops <= 0:
        return None
    return 100.0 * ctx.train_flops / (secs * ctx.peak_flops)
