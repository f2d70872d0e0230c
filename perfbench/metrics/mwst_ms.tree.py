"""mwst_ms.tree: the weights, the Boruvka MWST and the edge list's read
back, in ms (CUDA events around the staged calls, their median)."""


def read(ctx):
    t = ctx.stage_s("mwst")
    if t is None or ctx.unit != "tree" or not ctx.on_card:
        return None
    return 1e3 * t
