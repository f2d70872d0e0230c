"""experts_roofline.hybrid: the routed experts' floor (6 T k d f
operations a layer at the chip's dense bf16 peak, or the held experts'
weights and the tokens in and out, counted from the configuration;
``roofline_hybrid``) over the ``repro_torch.experts`` spans' CUDA-event
time (the gather, the grouped GEMMs, the combine) in one prefill, in
%."""
from perfbench import lm_spans, roofline


def read(ctx):
    return lm_spans.stage_share(ctx, "repro_torch.experts", "experts",
                                roofline.BF16_PEAKS)
