"""attn_roofline.prefill: the causal attention's floor (its operations,
4 B Hq Dh S(S+1)/2 a layer, at the chip's dense bf16 peak, or its bytes)
over the device time of the ``flash_prefill`` kernels in the traced
calls, in %."""
from perfbench import lm_ops, roofline


def read(ctx):
    got, c = lm_ops.per_call(ctx), ctx.counts.get("attention")
    if got is None or c is None:
        return None
    ops, calls = got
    t = lm_ops.seconds(ops, "attention")
    return roofline.share(c[0] * calls, c[1] * calls, t, ctx.device_name,
                          roofline.BF16_PEAKS)
