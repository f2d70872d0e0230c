"""ssd_roofline.hybrid: the chunked SSD's floor (its operations at chunk
256 at the chip's dense TF32 peak, or its least bytes: x, dt, B, C in and
y out a token, each row's final state; ``roofline_hybrid``) over the
``repro_torch.ssd`` spans' CUDA-event time in one prefill, in %."""
from perfbench import lm_spans, roofline_hybrid


def read(ctx):
    return lm_spans.stage_share(ctx, "repro_torch.ssd", "ssd",
                                roofline_hybrid.TF32_PEAKS)
