"""mfu.hybrid: a whole hybrid prefill's model operations (its GEMMs, its
causal attention and its SSD, ``counts()["whole"]``) at the chip's dense
bf16 peak over the median time of a whole prefill in the same run, in %.
The time is the host clock's around whole calls."""
from perfbench import roofline


def read(ctx):
    t, c = ctx.whole_median_s(), ctx.counts.get("whole")
    if ctx.unit != "token" or t is None or c is None or not ctx.on_card \
            or "ssd" not in ctx.counts:
        return None
    return roofline.share(c[0], 0, t, ctx.device_name, roofline.BF16_PEAKS)
