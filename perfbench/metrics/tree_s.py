"""tree_s: the window's seconds over the trees it completed."""


def read(ctx):
    if ctx.unit != "tree" or not ctx.units or not ctx.on_card:
        return None
    return ctx.window_s / ctx.units
