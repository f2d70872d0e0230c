"""moe_ms.hybrid: a prefill's MoE layers (the ``repro_torch.moe`` spans:
routing, dispatch, the routed experts, the combine and the shared
expert), summed over its layers, in ms (CUDA events; median over the
profiled prefills)."""
from perfbench import lm_spans


def read(ctx):
    return lm_spans.stage_ms(ctx, "repro_torch.moe")
