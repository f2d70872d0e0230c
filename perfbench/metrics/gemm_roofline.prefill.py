"""gemm_roofline.prefill: the GEMMs' floor (2 m k n of every projection
and MLP product over every token and of the LM head over each row's last
position, at the chip's dense bf16 peak, or their bytes) over the device
time of the GEMM kernels in the traced calls, in %."""
from perfbench import lm_ops, roofline


def read(ctx):
    got, c = lm_ops.per_call(ctx), ctx.counts.get("gemm")
    if got is None or c is None:
        return None
    ops, calls = got
    t = lm_ops.seconds(ops, "matmul")
    return roofline.share(c[0] * calls, c[1] * calls, t, ctx.device_name,
                          roofline.BF16_PEAKS)
