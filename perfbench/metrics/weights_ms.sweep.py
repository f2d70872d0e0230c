"""weights_ms.sweep: the batched encode, Gram and weights of every
strategy, ms in one staged sweep (CUDA events, median)."""


def read(ctx):
    t = ctx.stage_s("weights")
    if t is None or ctx.unit != "trial" or not ctx.on_card:
        return None
    return 1e3 * t
