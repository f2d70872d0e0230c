"""encode_roofline.tree: the encode stage's bytes floor (f32 samples in,
the payload out) over its CUDA-event time, in %."""
from perfbench import roofline


def read(ctx):
    t, c = ctx.stage_s("encode"), ctx.counts.get("encode")
    if t is None or c is None or not ctx.on_card:
        return None
    return roofline.share(*c, t, ctx.device_name)
