"""entry_gram_roofline.tree: the Gram stage's floor (the distinct
entries' operations at the chip's dense peak, or its bytes) over the
CUDA-event time of the timed entry's own ``repro_torch.gram`` span, in %
(median over the profiled trees)."""
from perfbench import roofline, spans


def read(ctx):
    c = ctx.counts.get("gram")
    t = spans.per_root(ctx, "tree",
                       lambda g: spans.stage_s(g, "repro_torch.gram"))
    if t is None or c is None:
        return None
    return roofline.share(*c, t, ctx.device_name)
