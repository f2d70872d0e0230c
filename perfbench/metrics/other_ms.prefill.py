"""other_ms.prefill: the device time a prefill spends in every operation
that is neither attention nor a GEMM (norms, RoPE, SwiGLU's product, the
embedding, casts, cache copies, memsets), in ms."""
from perfbench import lm_ops


def read(ctx):
    got = lm_ops.per_call(ctx)
    if got is None:
        return None
    ops, calls = got
    return 1e3 * lm_ops.seconds(ops, "elementwise") / calls
