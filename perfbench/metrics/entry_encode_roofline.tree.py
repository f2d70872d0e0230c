"""entry_encode_roofline.tree: the encode stage's bytes floor (f32
samples in, the payload out) over the CUDA-event time of the timed
entry's own ``repro_torch.encode`` span, in % (median over the profiled
trees)."""
from perfbench import roofline, spans


def read(ctx):
    c = ctx.counts.get("encode")
    t = spans.per_root(ctx, "tree",
                       lambda g: spans.stage_s(g, "repro_torch.encode"))
    if t is None or c is None:
        return None
    return roofline.share(*c, t, ctx.device_name)
