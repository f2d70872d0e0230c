"""mst_ms.sweep: the batched Boruvka MWST and metric sums, ms in one
staged sweep (CUDA events, median)."""


def read(ctx):
    t = ctx.stage_s("mst")
    if t is None or ctx.unit != "trial" or not ctx.on_card:
        return None
    return 1e3 * t
