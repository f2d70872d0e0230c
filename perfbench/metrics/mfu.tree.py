"""mfu.tree: the whole tree's operations floor (its Gram's distinct
entries at the chip's dense peak) over the median time of a whole tree
in the same run, in %. The time is the host clock's around whole
calls, so it holds the host's share of each call beside the device's."""
from perfbench import roofline


def read(ctx):
    t, c = ctx.whole_median_s(), ctx.counts.get("whole")
    if ctx.unit != "tree" or t is None or c is None or not ctx.on_card:
        return None
    return roofline.share(c[0], 0, t, ctx.device_name)
