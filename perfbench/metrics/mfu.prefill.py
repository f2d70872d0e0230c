"""mfu.prefill: a whole prefill's model operations (its GEMMs and its
causal attention, ``counts()["whole"]``) at the chip's dense bf16 peak
over the median time of a whole prefill in the same run, in %. The time
is the host clock's around whole calls, so it holds the host's share of
each call beside the device's."""
from perfbench import roofline


def read(ctx):
    t, c = ctx.whole_median_s(), ctx.counts.get("whole")
    if ctx.unit != "token" or t is None or c is None or not ctx.on_card:
        return None
    return roofline.share(c[0], 0, t, ctx.device_name, roofline.BF16_PEAKS)
