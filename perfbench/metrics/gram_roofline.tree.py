"""gram_roofline.tree: the Gram stage's floor (the distinct entries'
operations at the chip's dense peak, or its bytes) over its CUDA-event
time, in %."""
from perfbench import roofline


def read(ctx):
    t, c = ctx.stage_s("gram"), ctx.counts.get("gram")
    if t is None or c is None or not ctx.on_card:
        return None
    return roofline.share(*c, t, ctx.device_name)
