"""mamba_ms.hybrid: a prefill's Mamba2 mixers (the ``repro_torch.mamba``
spans: in_proj, the conv, the SSD, the gated norm, out_proj), summed over
its layers, in ms (CUDA events; median over the profiled prefills)."""
from perfbench import lm_spans


def read(ctx):
    return lm_spans.stage_ms(ctx, "repro_torch.mamba")
