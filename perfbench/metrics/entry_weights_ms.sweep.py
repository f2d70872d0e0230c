"""entry_weights_ms.sweep: every strategy's encode, Gram and weights
in the timed entry (``repro_torch.stats`` spans summed over a
sweep's points), ms on their CUDA events (median over the profiled
sweeps)."""
from perfbench import spans


def read(ctx):
    t = spans.per_root(ctx, "trial",
                       lambda g: spans.stage_s(g, "repro_torch.stats"))
    return None if t is None else 1e3 * t
